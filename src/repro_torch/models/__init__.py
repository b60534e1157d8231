"""Model stack of the port: layers, attention, caches and assembly."""
