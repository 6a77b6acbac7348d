"""Command-line tools of the port (``python -m rocksplicator_tpu_torch.tools.<name>``)."""
