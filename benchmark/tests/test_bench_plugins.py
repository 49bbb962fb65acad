"""A configuration, a traffic mix and a per-layer metric added as new files and
new entries are found by name, with no file of the harness edited."""

from __future__ import annotations

import hashlib
import json
import time

import pytest
import torch

import _tiny
from benchmark import harness
from benchmark import run as bench_run


def _digests(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*.py")}


def test_new_files_are_found_by_name(tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    root = _tiny.make(tmp_path)
    before = _digests(root)
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg["unet"]["num_heads"] = 2
    (root / "benchmark/configs/tiny-2heads.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/tiny-image.json").read_text())
    traffic["pairs"] = 1
    (root / "benchmark/traffic/one-pair.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/forwards_a_pair.image.py").write_text(
        "def read(run):\n    return run['unet_forwards'] / run['units']\n")
    # a metric of module ranges of its own: the harness marks what it declares
    (root / "benchmark/metrics/gn_calls.py").write_text(
        "RANGES = {'gn': lambda model: [m for m in model.unet.modules() if type(m).__name__ == 'GroupNorm32']}\n"
        "def read(run):\n    return float(len(run['shapes']['gn']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-2heads", "source": "tests", "file": "benchmark/configs/tiny-2heads.json",
                             "reduced": ["num_heads"], "why": "tests"})
    bench["workloads"].append({"name": "tiny-one-pair", "config": "tiny-2heads", "traffic": "one-pair",
                               "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "forwards_a_pair.image", "unit": "evals", "better": "lower",
                               "source": "program_counter", "layer": "samplers", "moves": "pairs_per_s",
                               "workloads": ["tiny-one-pair"]})
    bench["per_layer"].append({"name": "gn_calls.image", "unit": "calls", "better": "lower",
                               "source": "program_counter", "layer": "models", "moves": "pairs_per_s",
                               "workloads": ["tiny-one-pair"]})
    bench["end_to_end"][1]["workloads"].append("tiny-one-pair")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.find_cell("tiny-one-pair", root)
    assert spec.config["unet"]["num_heads"] == 2 and spec.traffic["pairs"] == 1
    res = bench_run.run_cell(spec, 11, 0.1, True, device="cpu", t_start=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["forwards_a_pair.image"]["value"] == traffic["ddim_steps"]
    gn = res["metrics"]["gn_calls.image"]["value"]  # the UNet's GroupNorm calls over the marked call's evals
    assert gn > 0 and gn % traffic["ddim_steps"] == 0
    assert _digests(root).items() >= before.items()


def test_device_idle_reads_a_window_call():
    """The busy seconds of the profiled call over a window call's mean length,
    whatever the profiled call's own length."""
    from types import SimpleNamespace

    idle = harness.metric_module("device_idle.video")
    trace = SimpleNamespace(device=[(0, 1, "k")], busy_s=6.0, window_s=12.0)
    assert idle.read({"trace": trace, "calls": [7.0, 8.0, 9.0]}) == pytest.approx(25.0)
    assert idle.read({"trace": SimpleNamespace(device=[], busy_s=0.0, window_s=1.0), "calls": [1.0]}) is None
