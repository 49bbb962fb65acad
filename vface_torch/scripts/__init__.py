"""Command-line entry points (``python -m vface_torch.scripts.<name>``)."""
