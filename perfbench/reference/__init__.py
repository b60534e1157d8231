"""The plain float32 reference that a run's ``correct`` is judged against (see ``model``)."""
