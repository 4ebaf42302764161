"""Command-line entry points of the port (``python -m
ir2rgb_tpu_torch.cli.<name>``)."""
