"""Each cell's harness path end to end at test widths on the CPU: the program
in float32 against the reference, both traced and untraced; the control and
every fault the cells can have come out not correct."""

from __future__ import annotations

import time

import pytest
import torch

import _tiny
from benchmark import control, harness
from benchmark import run as bench_run

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return _tiny.make(tmp_path_factory.mktemp("bench"))


def _run(root, workload: str, trace: bool) -> dict:
    spec = harness.find_cell(workload, root)
    return bench_run.run_cell(spec, SEED, 0.2, trace, device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("workload", sorted(_tiny.TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_cpu(root, workload, trace):
    res = _run(root, workload, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    spec = harness.find_cell(workload, root)
    if trace:
        # the device-trace metrics have nothing to read on the CPU; the rest are there
        host = {m["name"] for m in spec.per_layer if m["source"] != "device_trace"}
        assert host and host <= set(res["metrics"])
        assert res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["checks"]["float32_in_tf32"] == {"value": 0, "limit": 0}
    for c in res["checks"].values():
        assert c["value"] < 1e-3  # float32 against float32: round-off


def _same_x(x, e_t, *args, **kw):
    return x, x


def _half_batch(forward):
    """The second half of the rows' predictions left out, the first half's in
    their place (the video's rows meet inside the UNet's fusion, so the whole
    batch still runs)."""
    def run(self, x, *args, **kw):
        out = forward(self, x, *args, **kw)
        eps = out[0] if isinstance(out, tuple) else out
        h = eps.shape[0] // 2
        eps = torch.cat([eps[:h], eps[:eps.shape[0] - h]], dim=0)
        return (eps, *out[1:]) if isinstance(out, tuple) else eps
    return run


def _altered(decode):
    """Every decoded answer altered: the check reads a sample drawn from the seed
    (one pair of a call's four), which meets a fault only where it lands."""
    def run(self, z):
        return decode(self, z) + 0.5
    return run


def _tf32_on(program_model):
    def build(*args, **kw):
        torch.backends.cudnn.allow_tf32 = True
        return program_model(*args, **kw)
    return build


FAULTS = ("step_unchanged", "half_batch", "answer_altered", "tf32_on")


@pytest.mark.parametrize("workload", sorted(_tiny.TINY))
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(root, workload, fault, monkeypatch):
    from vface_torch.models.ldm import VFaceModel
    from vface_torch.models.unet import UNetModel
    from vface_torch.samplers import ddim, vface

    if fault == "step_unchanged":
        monkeypatch.setattr(ddim, "ddim_step", _same_x)
        monkeypatch.setattr(vface, "ddim_step", _same_x)
    elif fault == "half_batch":
        monkeypatch.setattr(UNetModel, "forward", _half_batch(UNetModel.forward))
    elif fault == "answer_altered":
        monkeypatch.setattr(VFaceModel, "decode_first_stage", _altered(VFaceModel.decode_first_stage))
    else:  # the program turns TF32 on for the float32 convolutions the configuration states in float32
        monkeypatch.setattr(harness, "program_model", _tf32_on(harness.program_model))
    try:
        res = _run(root, workload, False)
    finally:
        harness.float32_as_stated()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(_tiny.TINY))
def test_control_fails_the_limit(root, workload):
    """The control goes through the cell's own check and comes out not correct."""
    spec = harness.find_cell(workload, root)
    checks = control.control_checks(spec, SEED, "cpu", calls=2)
    assert set(checks) == set(spec.traffic["check"])
    assert not harness.verdict(checks), checks
