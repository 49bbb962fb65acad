"""Nothing the benchmark runs loads JAX, Flax or the JAX package, compared by
whole top-level module names; the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from _tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "vface_tpu"}

_PROBE = r"""
import json, sys, runpy
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path("benchmark/run.py", run_name="__main__")
except SystemExit:
    pass
from pathlib import Path
from benchmark import control, harness
from benchmark.reference import pipelines, config
for kind in Path("benchmark/kinds").glob("*.py"):
    harness.load_module(kind)
for metric in Path("benchmark/metrics").glob("*.py"):
    harness.load_module(metric)
import vface_torch.pipelines.video_swap, vface_torch.pipelines.image_swap
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "vface_torch" in top and "benchmark" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _imported_tops(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    files = sorted((REPO / "benchmark/reference").glob("*.py"))
    assert files
    for f in files:
        tops = _imported_tops(f)
        assert not tops & (FORBIDDEN | {"vface_torch"}), (f.name, tops)


def test_no_benchmark_file_imports_jax():
    for f in sorted((REPO / "benchmark").rglob("*.py")):
        assert not _imported_tops(f) & FORBIDDEN, f
