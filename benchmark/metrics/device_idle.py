"""The device's idle share of a window call, in percent: one minus the device's
busy seconds in the profiled call (the union of its kernel and copy
intervals, no module marked: the same work as a window call, and the
profiler does not lengthen the device's work) over a window call's mean
length. The profiled call itself runs longer than a window call where the
host paces it (the profiler's cost a launch), so its own idle share, which
the result's ``busy_s`` and ``window_s`` give, reads higher."""


def read(run: dict):
    tr = run["trace"]
    if not tr.device or not run["calls"]:
        return None
    return 100.0 * (1.0 - tr.busy_s / (sum(run["calls"]) / len(run["calls"])))
