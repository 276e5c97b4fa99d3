"""Tools around the port: runtime checkpoints (``export_runtime``)."""
