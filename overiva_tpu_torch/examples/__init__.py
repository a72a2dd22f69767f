"""Command-line demos of the port, run as ``python -m
overiva_tpu_torch.examples.<name>``."""
