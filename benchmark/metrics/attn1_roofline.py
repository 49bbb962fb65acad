"""The self-attention sites' share of their roofline, in percent: the least
time of every attn1 call of the marked call (its four projections and both
products at the bf16 peak, or its input, output and weights at HBM
bandwidth, whichever is longer) over the device time of every kernel
between the markers of the attn1 calls (projections, FSAI / FGATS fusion, core)."""

from benchmark.flops import attn1_work, least_seconds

RANGES = {"attn1": lambda model: [m.attn1 for m in model.unet.modules() if hasattr(m, "attn1")]}


def read(run: dict):
    seconds = run["marked"].device_seconds_in("attn1") if run["marked"] else 0.0
    if not seconds or not run["shapes"].get("attn1"):
        return None
    least = sum(least_seconds(*attn1_work(b, n, c)) for b, n, c in run["shapes"]["attn1"])
    return 100.0 * least / seconds
