"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (imports, the kernels' build or load from ``build/``, weights made on
the device from the seed, a warm-up at the cell's shapes) is timed as
``setup_s``. Then calls go back to back, closed loop, until ``--seconds``
have passed; the call under way finishes and counts, no new one starts. The
rate is all units completed over all the calls' time. ``--trace 0`` reports
the cell's end-to-end metrics; ``--trace 1`` runs the same window with the
program's stage clocks on and a UNet forward counter, then one more call
under ``torch.profiler`` as the program runs it (the device's busy and idle
time), then, where a metric declares module ranges (``RANGES``), one call
with those ranges marked on the device's timeline, and reports the per-layer
metrics. Either way the program is then freed and a sample of the window's
outputs, drawn from the seed, is recomputed by the plain float32 reference;
``correct`` holds when every compared number is within its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _setup_paths() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


_setup_paths()

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Counter:
    """Forward calls of a module (the UNet's evals)."""

    def __init__(self, module):
        self.calls = 0
        self._h = module.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.calls += 1

    def remove(self) -> None:
        self._h.remove()


def run_cell(spec, seed: int, seconds: float, trace: bool, device="cuda", t_start: float = None) -> dict:
    """One run of a cell; returns the result line's fields and the checks."""
    t_start = T_START if t_start is None else t_start
    harness.float32_as_stated()
    cell = harness.kind_module(spec.traffic, spec.root).Cell(spec.config, spec.traffic, seed, device)
    t_build = time.perf_counter()
    cell.build()
    _sync(device)
    t_warm = time.perf_counter()
    cell.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: imports {t_build - t_start:.3f} s, build {t_warm - t_build:.3f} s, "
          f"warm-up {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)

    counter = Counter(cell.network().unet) if trace else None
    timings = {} if trace else None
    calls, kept, units = [], [], 0
    tf32 = harness.tf32_check()
    start = time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        inputs = cell.inputs(len(calls))
        _sync(device)
        t0 = time.perf_counter()
        out = cell.call(inputs, timings)
        _sync(device)
        calls.append(time.perf_counter() - t0)
        kept.append(cell.keep(out))
        units += cell.units(inputs)
    window_s = sum(calls)
    tf32["float32_in_tf32"]["value"] |= harness.tf32_check()["float32_in_tf32"]["value"]
    dev_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu",
                "count": spec.chips,
                "memory_peak_bytes": torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0}

    result = {"attempted": len(calls), "failed": 0}
    if trace:
        counter.remove()
        readers = {m["name"]: harness.metric_module(m["name"], spec.root) for m in spec.per_layer}
        record = dict(kind=spec.traffic["kind"], units=units, window_s=window_s, calls=calls, timings=timings,
                      unet_forwards=counter.calls, model_flops=cell.flops_per_call() * len(calls),
                      config=spec.config, traffic=spec.traffic)
        record.update(profiled_calls(cell, device, len(calls), readers.values()))
        tr = record["trace"]
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        metrics = {}
        for m in spec.per_layer:
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        marked = record["marked"]
        result["diagnostics"] = {"kernels": len(tr.device), "profiled_call_s": tr.window_s, "window_calls_s": calls,
                                 "marked_call_s": None if marked is None else marked.window_s,
                                 "ranges_marked": None if marked is None else marked.ranges_ok}
    else:
        values = {cell.rate_metric: units / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev_info
    cell.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = {**cell.check(kept, seed), **tf32}
    result["correct"] = harness.verdict(result["checks"])
    return result


def _profiled(cell, device, inputs, ranges):
    """One call under the profiler (the device's activity only, so that the host
    runs as in the window); its device timeline reduced."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    try:
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            _sync(device)
            t0 = time.perf_counter()
            cell.call(inputs, None)
            _sync(device)
            window_s = time.perf_counter() - t0
    finally:
        ranges.remove()
    return harness.Trace(prof.profiler.kineto_results.events(), window_s, ranges)


def profiled_calls(cell, device, index: int, readers) -> dict:
    """``trace``: one more call profiled as the program runs it. ``marked``: where
    a metric declares ``RANGES`` ({range name: the program's modules, from its
    model}), one call more with those modules' calls marked (a marker kernel as
    each starts and ends, which costs launches, so that call serves the ranges
    alone); ``shapes``: each range's input shapes, in order."""
    inputs = cell.inputs(index)
    trace = _profiled(cell, device, inputs, harness.Ranges(device))
    wanted = {}
    for reader in readers:
        wanted.update(getattr(reader, "RANGES", {}))
    if not wanted:
        return {"trace": trace, "marked": None, "shapes": {}}
    ranges = harness.Ranges(device)
    for name, select in wanted.items():
        ranges.add(name, select(cell.network()))
    return {"trace": trace, "marked": _profiled(cell, device, inputs, ranges), "shapes": ranges.shapes}


def emit(result: dict) -> int:
    """The checks on standard error, then the result line, ``checks`` last."""
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": result.pop("correct"), **result, "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {spec.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    return emit(run_cell(spec, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
