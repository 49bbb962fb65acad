"""Seconds a pair in the image core's stages around the sampler: conditioning,
encode and decode (the program's stage clocks, summed over the window's
calls), over the pairs completed."""

STAGES = ("conditioning", "encode", "decode")


def read(run: dict):
    if not run["timings"] or not run["units"]:
        return None
    return sum(run["timings"].get(s, 0.0) for s in STAGES) / run["units"]
