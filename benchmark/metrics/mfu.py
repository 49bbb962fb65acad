"""Model FLOPs of the work completed in the window (benchmark/flops.py, at the
cell's fixed operating point, whatever the program ran), over the window's
seconds, as a share of the chip's dense bf16 peak, in percent."""

from benchmark.flops import PEAKS


def read(run: dict):
    if not run["window_s"]:
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / PEAKS["bf16_flops"]
