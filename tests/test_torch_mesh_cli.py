"""The video CLI's mesh flags (``--mesh_data`` / ``--mesh_frames``) on 2 gloo ranks.

Torch only: the port's seeded ``--tiny`` weights, a 5-frame 48 x 64 Y4M
and a source PNG, ``--n_frames 2 --ddim_steps 2 --inversion_steps 2`` (two
full windows and a 1-frame one) on the CPU. The CLI runs in process on each
rank (``tests/_torch_dist.py``), as ``torchrun`` would start it. Held: the
Y4M frames of ``--mesh_data 2`` and of ``--mesh_frames 2`` within 2 uint8
levels of the single-device CLI's and the sink's PNGs of ``--mesh_data``
within 1 (the paths give the sequential loop's frames within 2e-5,
``tests/test_torch_sharded_video.py``; uint8 truncation can fall either side
of a level, and the YUV conversion rounds once more: the limits of
``tests/test_torch_cli.py``), rank 0 alone writing the outputs;
``--mesh_frames`` refusing a pair with ``masks:`` (a ``[fail]`` line, exit
code 1); a mesh size other than the world size, and both flags at once,
refused before any work; a rank that fails inside a video's swap ends the
run on every rank instead of leaving the others in its collectives.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks, spawn_ranks
from vface_torch.io.image import read_png, write_png
from vface_torch.io.video import read_y4m, write_y4m
from vface_torch.scripts import vface_video_swap as cli

N, H, W = 5, 48, 64
COMMON = ["--tiny", "--n_frames", "2", "--ddim_steps", "2", "--inversion_steps", "2"]


def _inputs(d):
    base = torch.from_numpy(np.random.default_rng(41).normal(size=(N + 1, 3, H // 8, W // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear", align_corners=False)
    clip = (torch.sigmoid(up).permute(0, 2, 3, 1).numpy() * 255).astype(np.uint8)
    write_y4m(str(d / "a.y4m"), clip[:N], fps=10)
    write_png(str(d / "src.png"), clip[N])
    (d / "masks").mkdir()
    for i in range(N):
        write_png(str(d / "masks" / f"{i}.png"), np.ones((H, W), np.uint8))
    (d / "one.yaml").write_text(f"- video: {d / 'a.y4m'}\n  source: {d / 'src.png'}\n")
    (d / "masked.yaml").write_text(f"- video: {d / 'a.y4m'}\n  source: {d / 'src.png'}\n  masks: {d / 'masks'}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    _inputs(d)
    os.environ["VFACE_PLATFORM"] = "cpu"
    try:
        assert cli.main(["--config", str(d / "one.yaml"), "--outdir", str(d / "plain"), *COMMON]) == 0
    finally:
        os.environ.pop("VFACE_PLATFORM", None)
    argvs = [["--config", str(d / "one.yaml"), "--outdir", str(d / "data"), "--mesh_data", "2", *COMMON],
             ["--config", str(d / "one.yaml"), "--outdir", str(d / "frames"), "--mesh_frames", "2", *COMMON],
             ["--config", str(d / "masked.yaml"), "--outdir", str(d / "masked"), "--mesh_frames", "2", *COMMON]]
    (d / "ranks").mkdir()
    codes = run_ranks("video_cli", 2, dict(argvs=argvs), d / "ranks")
    return d, codes


def _frames(path):
    return read_y4m(str(path))[0].astype(np.int32)


@pytest.mark.parametrize("run", ["data", "frames"])
def test_mesh_flags_give_the_single_device_frames(runs, run):
    d, codes = runs
    assert codes[0][:2] == codes[1][:2] == [0, 0]
    got, want = _frames(d / run / "a.y4m"), _frames(d / "plain" / "a.y4m")
    assert got.shape == want.shape == (N, H, W, 3)
    assert np.abs(got - want).max() <= 2
    files = sorted(os.listdir(d / run))
    assert {"a.avi", "a.y4m", "a.gif"} <= set(files)
    if run == "data":  # rank 0's sink and manifest (the frame-sharded path keeps neither, as JAX's)
        assert "a.manifest.json" in files
        names = [f"{i}.png" for i in range(N)]
        assert sorted(os.listdir(d / run / "a_frames")) == names
        for n in names:
            got = read_png(str(d / run / "a_frames" / n), mode="RGB").astype(np.int32)
            assert np.abs(got - read_png(str(d / "plain" / "a_frames" / n), mode="RGB")).max() <= 1


def test_mesh_frames_refuses_precomputed_masks(runs):
    d, codes = runs
    assert codes[0][2] == 1  # rank 0 counts the [fail]
    assert not (d / "masked" / "a.avi").exists()


def test_mesh_size_must_be_the_world_size(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VFACE_PLATFORM", "cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = cli.main(["--config", str(tmp_path / "none.yaml"), "--mesh_data", "2", *COMMON])
    assert code == 2 and "torchrun --nproc_per_node 2" in err.getvalue()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.parse_args(["--config", "x", "--mesh_data", "2", "--mesh_frames", "2"])


def test_a_failing_rank_ends_the_run(tmp_path):
    _inputs(tmp_path)
    argv = ["--config", str(tmp_path / "one.yaml"), "--outdir", str(tmp_path / "out"), "--mesh_frames", "2", *COMMON]
    (tmp_path / "ranks").mkdir()
    codes, errs = spawn_ranks("video_cli_rank_fails", 2, dict(argvs=[argv]), tmp_path / "ranks", timeout=120)
    assert all(c not in (0, None, -9) for c in codes), codes  # every rank failed, and none was killed
    assert "injected failure on the last rank" in errs[1] and 0 in errs
    assert not (tmp_path / "out" / "a.avi").exists()
