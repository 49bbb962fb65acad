"""BENCHMARK.json against the benchmark's contract: names, units, keys, and the
files each entry names."""

from __future__ import annotations

import json
import re

from _tiny import REPO
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert harness.metric_path(m["name"], REPO).is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for w in BENCH["workloads"]:
        listed = lambda m: w["name"] in m.get("workloads", [w["name"]])
        e2e = {m["name"] for m in BENCH["end_to_end"] if listed(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(listed(m) for m in BENCH["per_layer"])
        for m in BENCH["per_layer"]:
            if listed(m):
                assert m["moves"] in e2e
