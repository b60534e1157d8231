"""Step factories and the fault-tolerant trainer, ported from ``repro.train``.

The trainer is imported lazily (``repro_torch.train.trainer``): the serving
path imports ``train.steps`` and has no use for the data pipeline or the
checkpoint manager.
"""
