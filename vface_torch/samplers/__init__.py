"""DDIM step, DDIM inversion and the VFace hooked sampler."""
