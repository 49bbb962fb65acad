"""The slice as a whole: the port's ``vface_video_swap`` CLI against the JAX package's.

One config of two pairs: a 4-frame 48 x 64 Y4M with a ``.wav`` beside it,
and the same clip under another name with a ``masks:`` directory of parse
maps. Both CLIs run ``--tiny`` on the same ``--params`` / ``--aux_params``
npz files (written by the JAX package's ``save_params_npz`` from seeded
numpy), ``--n_frames 3 --ddim_steps 2 --inversion_steps 2``; the JAX CLI is
called once (``scripts/vface_video_swap.py::main`` with ``sys.argv``
patched), the port's ``main(argv)`` with ``VFACE_PLATFORM=cpu``.

Limits: the sink's PNG frames within 1 uint8 level (the pipelines agree
within 1e-4 in [0, 1], and the truncation to uint8 can fall either side of a
level), the Y4M read back within 2 (the YUV conversion rounds once more),
the manifests' windows and frame counts and the AVI's stream headers equal.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import seeded_bundle_params, seeded_flax_params
from vface_torch.io.image import read_png, write_png
from vface_torch.io.video import read_y4m, write_y4m
from vface_torch.scripts import vface_video_swap as port_cli

REPO = Path(__file__).resolve().parents[1]
PAIRS = ("a", "b")
N, H, W = 4, 48, 64
COMMON = ["--tiny", "--n_frames", "3", "--ddim_steps", "2", "--inversion_steps", "2"]


def _clip(seed):
    """Seeded smooth frames, uint8 (N, H, W, 3)."""
    base = torch.from_numpy(np.random.default_rng(seed).normal(size=(N + 1, 3, H // 8, W // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear", align_corners=False)
    return (torch.sigmoid(up).permute(0, 2, 3, 1).numpy() * 255).astype(np.uint8)


def _write_inputs(d: Path) -> dict:
    import jax.numpy as jnp

    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.models.raft import RAFT, RAFTConfig
    from vface_tpu.preprocess.landmarks import load_default_landmark_params
    from vface_tpu.runtime.checkpoint import save_params_npz

    clip = _clip(seed=21)
    for name in PAIRS:
        write_y4m(str(d / f"{name}.y4m"), clip[:N], fps=10)
    with wave.open(str(d / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(np.random.default_rng(22).integers(-3000, 3000, 3200, dtype=np.int16).tobytes())
    write_png(str(d / "src.png"), clip[N])
    (d / "masks").mkdir()
    yy, xx = np.mgrid[:H, :W]
    for i in range(N):  # an ellipse of skin (1) with hair (17) above it
        face = ((yy - H * 0.55) / (H * 0.3)) ** 2 + ((xx - W * 0.5 - i) / (W * 0.2)) ** 2 <= 1.0
        m = np.where(face, 1, 0).astype(np.uint8)
        m[(yy < H * 0.35) & (np.abs(xx - W * 0.5 - i) < W * 0.2)] = 17
        write_png(str(d / "masks" / f"{i}.png"), m)
    (d / "pairs.yaml").write_text(f"- video: {d / 'a.y4m'}\n  source: {d / 'src.png'}\n"
                                  f"- video: {d / 'b.y4m'}\n  source: {d / 'src.png'}\n  masks: {d / 'masks'}\n")
    save_params_npz(str(d / "params.npz"), seeded_bundle_params(JModel(JConfig.tiny(image_size=32)), seed=23))
    x = jnp.zeros((1, 32, 32, 3))
    save_params_npz(str(d / "aux.npz"), {
        "bisenet": seeded_flax_params(BiSeNet(), jnp.zeros((1, 64, 64, 3)), seed=24),
        "raft": seeded_flax_params(RAFT(RAFTConfig(iters=2)), x, x, seed=25),
        "landmark": load_default_landmark_params()})
    return {"config": str(d / "pairs.yaml"), "params": str(d / "params.npz"), "aux": str(d / "aux.npz")}


def _argv(inp, outdir):
    return ["--config", inp["config"], "--outdir", str(outdir), "--params", inp["params"],
            "--aux_params", inp["aux"], *COMMON]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    inp = _write_inputs(d)
    spec = importlib.util.spec_from_file_location("jax_vface_video_swap", REPO / "scripts" / "vface_video_swap.py")
    jax_cli = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFACE_PLATFORM", "cpu")
        spec.loader.exec_module(jax_cli)
        mp.setattr(sys, "argv", ["vface_video_swap.py", *_argv(inp, d / "jax")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_cli.main()
        jax_log = out.getvalue()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = port_cli.main(_argv(inp, d / "port"))
        port_log = out.getvalue()
    return dict(d=d, inp=inp, jax=d / "jax", port=d / "port", jax_log=jax_log, port_log=port_log, rc=rc)


def test_both_clis_finish_every_pair(runs):
    assert runs["rc"] == 0
    for log in (runs["jax_log"], runs["port_log"]):
        assert [ln.split(":")[0] for ln in log.splitlines() if ln.startswith("[")] == ["[done] a", "[done] b"]


@pytest.mark.parametrize("pair", PAIRS)
def test_sink_frames_match_jax(runs, pair):
    """Every frame PNG within 1 uint8 level of the JAX CLI's."""
    got = np.stack([read_png(str(runs["port"] / f"{pair}_frames" / f"{i}.png")) for i in range(N)]).astype(int)
    want = np.stack([read_png(str(runs["jax"] / f"{pair}_frames" / f"{i}.png")) for i in range(N)]).astype(int)
    assert got.shape == want.shape == (N, H, W, 3)
    print(f"{pair}: bit-equal share {float((got == want).mean()):.5f}")
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("pair", PAIRS)
def test_manifests_match_jax(runs, pair):
    """The same windows with the same frame counts, outputs in the same places, the same fingerprint."""
    got, want = (json.loads((runs[k] / f"{pair}.manifest.json").read_text()) for k in ("port", "jax"))
    assert {k: v["frames"] for k, v in got["windows"].items()} == {"0": 3, "3": 1}
    assert {k: v["frames"] for k, v in want["windows"].items()} == {"0": 3, "3": 1}
    assert got["meta"] == want["meta"]
    for k in got["windows"]:
        assert ([os.path.relpath(p, runs["port"]) for p in got["windows"][k]["outputs"]]
                == [os.path.relpath(p, runs["jax"]) for p in want["windows"][k]["outputs"]])


@pytest.mark.parametrize("pair", PAIRS)
def test_y4m_and_gif_match_jax(runs, pair):
    """The Y4M reads back within 2 levels of the JAX CLI's, at its fps; both
    GIFs last N frames at 10 fps (PIL merges equal consecutive frames, adding
    their durations)."""
    from PIL import Image

    got, fps = read_y4m(str(runs["port"] / f"{pair}.y4m"))
    want, jfps = read_y4m(str(runs["jax"] / f"{pair}.y4m"))
    assert got.shape == want.shape == (N, H, W, 3) and fps == jfps == 10
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    for k in ("port", "jax"):
        with Image.open(runs[k] / f"{pair}.gif") as g:
            ms = 0
            for i in range(g.n_frames):
                g.seek(i)
                ms += g.info["duration"]
            assert g.size == (W, H) and ms == N * 100, k


def _avi_headers(path: Path) -> bytes:
    """The AVI's ``hdrl`` list (main header, each stream's strh and strf)."""
    data = path.read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    at = data.index(b"LIST", 12)
    assert data[at + 8:at + 12] == b"hdrl"
    return data[at:at + 8 + int.from_bytes(data[at + 4:at + 8], "little")]


@pytest.mark.parametrize("pair", PAIRS)
def test_avi_headers_match_jax(runs, pair):
    """The AVI's stream headers equal the JAX CLI's (pair a carries the wav as an audio stream)."""
    got, want = (_avi_headers(runs[k] / f"{pair}.avi") for k in ("port", "jax"))
    assert got == want and got.count(b"strh") == (2 if pair == "a" else 1)
    assert (runs["port"] / f"{pair}.avi").stat().st_size == (runs["jax"] / f"{pair}.avi").stat().st_size


def test_finished_videos_are_skipped(runs, capsys):
    """A rerun into the same outdir skips both pairs (their .avi exists)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFACE_PLATFORM", "cpu")
        assert port_cli.main(_argv(runs["inp"], runs["port"])) == 0
    out = capsys.readouterr().out
    assert "[skip] a: output exists" in out and "[skip] b: output exists" in out


@pytest.mark.parametrize("flag", [["--mesh_data", "2"], ["--mesh_frames", "2"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli.main(["--config", str(tmp_path / "none.yaml"), "--tiny", *flag])


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without ``VFACE_PLATFORM=cpu`` the CLI runs on CUDA, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("VFACE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--config", str(tmp_path / "none.yaml"), "--tiny"])
    monkeypatch.setenv("VFACE_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VFACE_PLATFORM"):
        port_cli.main(["--config", str(tmp_path / "none.yaml"), "--tiny"])
