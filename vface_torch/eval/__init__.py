"""Evaluation metrics of the port (LPIPS)."""
