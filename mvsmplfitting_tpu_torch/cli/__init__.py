"""Command-line entry points of the port (`python -m
mvsmplfitting_tpu_torch.cli.main`)."""
