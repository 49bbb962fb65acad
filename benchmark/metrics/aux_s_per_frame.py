"""Seconds a frame in the video stages around the windows' diffusion: align,
parse, conditionings, flow, background and paste-back (the program's stage
clocks, summed over the window's calls), over the frames completed."""

STAGES = ("align", "parse", "conditionings", "flow", "background", "paste_back")


def read(run: dict):
    if not run["timings"] or not run["units"]:
        return None
    return sum(run["timings"].get(s, 0.0) for s in STAGES) / run["units"]
