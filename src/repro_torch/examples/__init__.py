"""Runnable end-to-end drivers of the port (``python -m repro_torch.examples.<name>``)."""
