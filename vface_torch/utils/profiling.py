"""Stage timing, device memory and profiler traces (port of ``vface_tpu/utils/profiling.py``).

* :class:`StageTimer`: wall seconds per named stage; ``sync_on`` (a tensor, or
  a device) synchronises its CUDA device before the clock stops, so the
  device work queued inside the stage is counted in it;
* :func:`trace`: a ``torch.profiler`` trace (CPU and CUDA activity) of what
  runs inside, written as a Chrome trace into ``logdir``;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` per CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def _sync(on) -> None:
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(logdir: str = "vface_trace"):
    """Profile what runs inside with ``torch.profiler`` (CUDA activity where a
    card is present); the Chrome trace goes to ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> Dict[str, Optional[dict]]:
    """``{"cuda:i": torch.cuda.memory_stats(i)}`` for every CUDA device (empty without one)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(n)}
