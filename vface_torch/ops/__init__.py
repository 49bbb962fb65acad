"""Fusion, warping and attention ops, and the hand-written kernels (K1-K3)."""
