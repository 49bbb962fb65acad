"""Milliseconds a UNet eval: the inversion's and the sampler's seconds (the
program's stage clocks; an image call has no inversion) over the UNet
forwards the benchmark's hook counted in the same calls."""


def read(run: dict):
    if not run["unet_forwards"]:
        return None
    return 1e3 * (run["timings"].get("invert", 0.0) + run["timings"].get("sample", 0.0)) / run["unet_forwards"]
