"""Command-line entry points: ``python -m mrfp_tpu_torch.cli.eval``."""
