"""Runnable end-to-end examples of the port (``python -m
africanus_tpu_torch.examples.<name>``)."""
