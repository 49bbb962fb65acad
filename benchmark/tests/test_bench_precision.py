"""The configurations state float32 for the conditioner and the aux nets. The
harness turns TF32 off for float32 products before it builds the program, and
every run's checks carry whether it was still off when the window opened and
closed (``float32_in_tf32``, limit 0; ``test_bench_cells`` plants the fault).
Here: no module of the program turns TF32 on, so the harness's setting is the
one the window runs under."""

from __future__ import annotations

import ast

import torch

from _tiny import REPO
from benchmark import harness


def _turns_tf32_on(tree) -> list:
    """Statements that set ``allow_tf32`` to anything but False, or ask for a
    float32 matmul precision below "highest" (a tuple put back as it was, as
    ``vface_torch/eval/_common.py::full_fp32`` does, is not one)."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            names = [t.attr for t in node.targets if isinstance(t, ast.Attribute)]
            if "allow_tf32" in names and not (isinstance(node.value, ast.Constant) and node.value.value is False):
                found.append(ast.unparse(node))
        elif isinstance(node, ast.Call) and ast.unparse(node.func).endswith("set_float32_matmul_precision"):
            if not (node.args and isinstance(node.args[0], ast.Constant) and node.args[0].value == "highest"):
                found.append(ast.unparse(node))
    return found


def test_no_program_module_turns_tf32_on():
    files = sorted((REPO / "vface_torch").rglob("*.py"))
    assert files
    found = {f.relative_to(REPO).as_posix(): hits for f in files if (hits := _turns_tf32_on(ast.parse(f.read_text())))}
    assert not found, found


def test_the_rule_finds_a_module_that_does():
    assert _turns_tf32_on(ast.parse("import torch\ntorch.backends.cudnn.allow_tf32 = True\n"))
    assert _turns_tf32_on(ast.parse("torch.set_float32_matmul_precision('high')\n"))
    assert not _turns_tf32_on(ast.parse("torch.backends.cudnn.allow_tf32 = False\n"))


def test_harness_turns_tf32_off_and_reads_it():
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert harness.tf32_check()["float32_in_tf32"]["value"] == 1
    finally:
        harness.float32_as_stated()
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert harness.tf32_check() == {"float32_in_tf32": {"value": 0, "limit": 0}}
