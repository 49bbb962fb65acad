"""The training driver and CLI against the JAX package's.

The port's ``train`` (CPU, the tiny config at 32^2, seeded params shared with
the JAX side as numpy) runs the same loop as ``make_train_step`` by hand, and
writes the same logdir as one JAX ``train()`` run (``n_data=1``, 2 steps, the
only JAX train step compiled in this file). ``validate`` runs with EMA weights;
the CLI (``VFACE_PLATFORM=cpu python -m vface_torch.scripts.train --tiny``)
trains 2 steps on a written CelebA-HQ-layout directory, then resumes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import np_tree, seeded_bundle_params
from vface_torch.data.datasets import write_synthetic_celeba
from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.pipelines import train as TT
from vface_torch.pipelines.train_driver import DriverConfig, _to_device, train, validate
from vface_torch.runtime.checkpoint import TrainCheckpointer
from vface_torch.scripts import train as cli
from vface_torch.utils.convert import from_flax_params
from vface_torch.utils.ema import ema_init, ema_update

REPO = Path(__file__).resolve().parents[1]
CFG = dict(reconstruct_steps=1, learning_rate=1e-3, warmup_steps=1)
DRIVER = dict(max_steps=2, log_every=1, image_log_every=2, ckpt_every=2, seed=7)


@pytest.fixture(scope="module")
def setup():
    from vface_tpu.models import ModelConfig as JConfig, VFaceModel as JModel

    jm = JModel(JConfig.tiny(image_size=32))
    params = seeded_bundle_params(jm, seed=51)
    rng = np.random.default_rng(52)
    clip = jm.cfg.cond.clip.image_size

    def batch():
        return {k: np.asarray(v, np.float32) for k, v in dict(
            gt_image=rng.uniform(-0.9, 0.9, (2, 32, 32, 3)), inpaint=rng.uniform(-0.9, 0.9, (2, 32, 32, 3)),
            mask=rng.uniform(size=(2, 32, 32, 1)) > 0.3, ref_clip=rng.normal(size=(2, clip, clip, 3)) * 0.3,
            ref_face01=rng.uniform(size=(2, 112, 112, 3)), landmarks=rng.uniform(size=(2, 136))).items()}

    return dict(jm=jm, params=params, state=from_flax_params(np_tree(params)), batches=[batch(), batch()])


def test_train_equals_the_step_by_hand(setup, tmp_path):
    """train() for 2 steps: the params equal make_train_step's twice on a
    generator seeded with DriverConfig.seed, bit for bit."""
    cfg = TT.TrainConfig(**CFG)
    got = train(ModelConfig.tiny(image_size=32), cfg, DriverConfig(logdir=str(tmp_path), **DRIVER),
                iter(setup["batches"]), init_params=setup["state"], device="cpu")
    m = VFaceModel(ModelConfig.tiny(image_size=32), device="cpu", conditioner=True)
    m.load_params(setup["state"])
    opt, sched = TT.make_optimizer(cfg, m)
    step = TT.make_train_step(m, opt, sched, cfg)
    gen = torch.Generator().manual_seed(DRIVER["seed"])
    for b in setup["batches"]:
        step(_to_device(b, "cpu"), gen)
    moved = 0
    for (name, a), b in zip(got.named_parameters(), m.parameters()):
        assert torch.equal(a, b), name
        moved += not torch.equal(a, setup["state"][_part(name)][name.split(".", 1)[1]])
    assert moved > 0


def _part(name):
    return {"conditioner": "cond"}.get(name.split(".")[0], name.split(".")[0])


def _layout(logdir):
    recs = [json.loads(x) for x in (Path(logdir) / "metrics.jsonl").read_text().splitlines()]
    return dict(steps=[r["step"] for r in recs], keys=[sorted(r) for r in recs],
                images=sorted(os.listdir(Path(logdir) / "images")),
                ckpts=sorted(n for n in os.listdir(Path(logdir) / "checkpoints") if not n.endswith(".tmp")),
                top=sorted(os.listdir(logdir)))


def test_logdir_layout_equals_jax(setup, tmp_path):
    """One JAX train() run and the port's on the same config write the same
    logdir: metrics.jsonl records with the same steps and keys (train/ loss
    terms, sec_per_it), images/rec_%08d.png, checkpoints/last and step_%08d
    (the values differ: JAX draws from threefry, the port from torch's
    generator)."""
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.pipelines.train import TrainConfig as JTrainConfig
    from vface_tpu.pipelines.train_driver import DriverConfig as JDriver, train as jtrain

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtrain(JConfig.tiny(image_size=32), JTrainConfig(**CFG), JDriver(logdir=str(jdir), **DRIVER),
           iter(setup["batches"]), init_params=setup["params"], n_data=1)
    train(ModelConfig.tiny(image_size=32), TT.TrainConfig(**CFG), DriverConfig(logdir=str(tdir), **DRIVER),
          iter(setup["batches"]), init_params=setup["state"], device="cpu")
    want, got = _layout(jdir), _layout(tdir)
    assert got == want
    assert got["images"] == ["rec_00000002.png"] and got["ckpts"] == ["last", "step_00000002"]
    assert "train/loss_simple" in got["keys"][0] and "train/sec_per_it" in got["keys"][0]
    last = TrainCheckpointer(str(tdir / "checkpoints")).restore_last()
    assert last["step"] == 2 and set(last["state"]) == {"params", "opt_state"}


def test_validate_with_ema_keys(setup):
    """validate: the mean logs as val/<key> and, with EMA weights, val/<key>_ema
    on the same draws; the EMA pass equals validate on a model holding the EMA
    weights; the model's own weights come back bit for bit."""
    m = VFaceModel(ModelConfig.tiny(image_size=32), device="cpu", conditioner=True)
    m.load_params(setup["state"])
    own = {n: p.detach().clone() for n, p in m.named_parameters()}
    ema = ema_init(own)
    ema = ema_update(ema, {n: p + 0.01 for n, p in own.items()})
    cfg = TT.TrainConfig(**CFG)
    got = validate(m, cfg, iter(setup["batches"]), generator=torch.Generator().manual_seed(1), ema_params=ema.params)
    keys = {"loss", "loss_simple", "loss_id"}
    assert set(got) == {f"val/{k}" for k in keys} | {f"val/{k}_ema" for k in keys}
    assert all(torch.equal(p, own[n]) for n, p in m.named_parameters())
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(ema.params[n])
    alone = validate(m, cfg, iter(setup["batches"]), generator=torch.Generator().manual_seed(1))
    for k in keys:
        assert got[f"val/{k}_ema"] == pytest.approx(alone[f"val/{k}"], rel=1e-6)
        assert got[f"val/{k}_ema"] != got[f"val/{k}"]


def test_cli_trains_resumes_and_refuses_an_empty_dataset(tmp_path, monkeypatch):
    """The CLI on the CPU (VFACE_PLATFORM=cpu, --tiny): 2 steps with the logdir
    layout; --resume with no step restores the saved params and saves them
    back bit for bit; --resume for one step starts its count at 0 (JAX's CLI
    starts a fresh optimizer); an empty dataset directory exits 1. Without
    VFACE_PLATFORM=cpu and without a card it raises."""
    data, logdir = tmp_path / "celeba", tmp_path / "logs"
    write_synthetic_celeba(str(data), 3, size=48, seed=4)
    monkeypatch.setenv("VFACE_PLATFORM", "cpu")
    common = ["--dataset_dir", str(data), "--logdir", str(logdir), "--tiny", "--log_every", "1",
              "--image_log_every", "2", "--ckpt_every", "2", "--seed", "3"]
    assert cli.main(common + ["--max_steps", "2"]) == 0
    assert _layout(logdir)["ckpts"] == ["last", "step_00000002"]
    ckpt = TrainCheckpointer(str(logdir / "checkpoints"))
    saved = ckpt.restore_last()
    assert saved["step"] == 2
    assert cli.main(common + ["--max_steps", "0", "--resume"]) == 0
    again = ckpt.restore_last()
    assert again["step"] == 0
    for part, sd in saved["state"]["params"].items():
        assert all(torch.equal(again["state"]["params"][part][k], v) for k, v in sd.items()), part
    assert cli.main(common + ["--max_steps", "1", "--resume"]) == 0
    assert ckpt.restore_last()["step"] == 1
    (tmp_path / "empty").mkdir()
    assert cli.main(["--dataset_dir", str(tmp_path / "empty"), "--logdir", str(tmp_path / "x"), "--tiny"]) == 1
    if not torch.cuda.is_available():
        monkeypatch.delenv("VFACE_PLATFORM")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(common + ["--max_steps", "1"])


def test_cli_runs_as_a_module(tmp_path):
    """python -m vface_torch.scripts.train exits 1 on an empty dataset directory."""
    (tmp_path / "empty").mkdir()
    out = subprocess.run([sys.executable, "-m", "vface_torch.scripts.train", "--dataset_dir", str(tmp_path / "empty"),
                          "--tiny"], cwd=REPO, env={**os.environ, "VFACE_PLATFORM": "cpu"}, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1 and "no CelebA-HQ images" in out.stderr
