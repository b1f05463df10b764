"""Command-line entry points (python -m cross_scale_mae_torch.cli.<name>)."""
