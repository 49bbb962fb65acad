"""The GEGLU feed-forwards' share of their roofline, in percent: the least time
of every FeedForward call of the marked call (both products at the bf16
peak, or its input, output and weights at HBM bandwidth, whichever is
longer) over the device time of every kernel between those calls' markers."""

from benchmark.flops import ff_work, least_seconds

RANGES = {"ff": lambda model: [m.ff for m in model.unet.modules() if hasattr(m, "ff")]}


def read(run: dict):
    seconds = run["marked"].device_seconds_in("ff") if run["marked"] else 0.0
    if not seconds or not run["shapes"].get("ff"):
        return None
    least = sum(least_seconds(*ff_work(b * n, c, 4 * c)) for b, n, c in run["shapes"]["ff"])
    return 100.0 * least / seconds
