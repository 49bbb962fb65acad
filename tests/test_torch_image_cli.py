"""The image CLIs against the JAX package's: ``inference_test_bench`` (the
whole CLI), ``one_inference`` (its ``swap_one``, the output names of both
modes), the watermark and the safety checker.

Both sides run ``--tiny`` (32^2 crops) on the same ``--params`` /
``--aux_params`` npz files, written by the JAX package's ``save_params_npz``
from seeded numpy; the JAX test-bench CLI is called once
(``scripts/inference_test_bench.py::main`` with ``sys.argv`` patched), the
port's ``main(argv)`` with ``VFACE_PLATFORM=cpu`` and its x_T source patched
to JAX's ``PRNGKey(42)`` draw. Four pairs at ``--batch 2``: two batches,
each from the same x_T.

Limits: the test bench's PNGs within 1 uint8 level (the swaps agree within
1e-4 in [0, 1], and the truncation to uint8 can fall either side of a
level); ``swap_one``'s full frame within 1e-4 in the mean and 1e-2 at most
(the aligned crops differ by fp32 round-off of the quad, which the
random-weight pipeline amplifies at a few pixels, as
``test_torch_multiface.py`` holds its frames); the watermark bit for bit;
the safety flags equal.
"""

import contextlib
import importlib.util
import io
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_tree, seeded_bundle_params, seeded_flax_params
from vface_torch.io.image import read_png, write_png
from vface_torch.pipelines import image_swap
from vface_torch.scripts import inference_test_bench as port_bench
from vface_torch.scripts import one_inference as port_one
from vface_torch.utils import watermark as port_wm

REPO = Path(__file__).resolve().parents[1]
S = 32  # the tiny crop side
N_PAIRS = 4
STEPS = ["--ddim_steps", "2"]


def jax_x_T(device=None, seed=42):
    """The JAX image core's x_T at the asked shape, as a noise source (the
    signature of ``seeded_noise``, which it replaces)."""
    def noise(idx, shape):
        r_noise, _ = jax.random.split(jax.random.PRNGKey(42))
        return torch.from_numpy(np.array(jax.random.normal(r_noise, shape, jnp.float32)))
    return noise


def _faces(n: int, size: int, seed: int) -> np.ndarray:
    from vface_torch.preprocess.synthetic_faces import render_face

    rng = np.random.default_rng(seed)
    return np.stack([render_face(rng, size)[0] for _ in range(n)]).astype(np.float32)


def _u8(x01) -> np.ndarray:
    return (np.clip(x01, 0, 1) * 255).astype(np.uint8)


def _jax_cli(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.models.bisenet import BiSeNet
    from vface_tpu.preprocess.landmarks import load_default_landmark_params
    from vface_tpu.runtime.checkpoint import save_params_npz

    d = tmp_path_factory.mktemp("image_cli")
    for sub in ("src", "tar", "mask"):
        (d / sub).mkdir()
    yy, xx = np.mgrid[:S, :S]
    for i, (src, tar) in enumerate(zip(_faces(N_PAIRS, S, 91), _faces(N_PAIRS, S, 92))):
        write_png(str(d / "src" / f"s{i}.png"), _u8(src))
        write_png(str(d / "tar" / f"t{i}.png"), _u8(tar))
        m = np.where(((yy - 17) / 9.0) ** 2 + ((xx - 16 - i) / 7.0) ** 2 <= 1.0, 1, 0).astype(np.uint8)
        m[(yy < 10) & (np.abs(xx - 16) < 6)] = 17
        write_png(str(d / "mask" / f"t{i}.png"), m)
    jm = JModel(JConfig.tiny(image_size=S))
    params = seeded_bundle_params(jm, seed=93)
    save_params_npz(str(d / "params.npz"), params)
    jaux = {"landmark": load_default_landmark_params(),
            "bisenet": seeded_flax_params(BiSeNet(), jnp.zeros((1, 64, 64, 3)), seed=94)}
    save_params_npz(str(d / "aux.npz"), {"landmark": jaux["landmark"]})
    return dict(d=d, jm=jm, params=params, jaux=jaux)


def _bench_argv(inp, outdir):
    d = inp["d"]
    return ["--src_dir", str(d / "src"), "--tar_dir", str(d / "tar"), "--mask_dir", str(d / "mask"),
            "--outdir", str(outdir), "--params", str(d / "params.npz"), "--aux_params", str(d / "aux.npz"),
            "--tiny", "--batch", "2", *STEPS]


@pytest.fixture(scope="module")
def bench_runs(inputs):
    from vface_tpu.models import VFaceModel as JModel

    d = inputs["d"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFACE_PLATFORM", "cpu")
        # --params replaces every leaf of the JAX CLI's init: give it the seeded
        # tree of the same structure, which compiles nothing
        init = seeded_bundle_params(inputs["jm"])
        mp.setattr(JModel, "init", lambda self, rng: init)
        jax_cli = _jax_cli("inference_test_bench")
        mp.setattr(sys, "argv", ["inference_test_bench.py", *_bench_argv(inputs, d / "jax_bench")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jax_cli.main()
        jax_log = out.getvalue()
        mp.setattr(image_swap, "seeded_noise", jax_x_T)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = port_bench.main(_bench_argv(inputs, d / "port_bench"))
        port_log = out.getvalue()
    return dict(jax=d / "jax_bench", port=d / "port_bench", jax_log=jax_log, port_log=port_log, rc=rc)


def test_test_bench_cli_matches_jax(bench_runs):
    """One PNG a pair, named by the target, each within 1 uint8 level of the JAX
    CLI's; both print the same "saved n" line but for the directory."""
    assert bench_runs["rc"] == 0
    names = sorted(os.listdir(bench_runs["jax"]))
    assert names == sorted(os.listdir(bench_runs["port"])) == [f"t{i}.png" for i in range(N_PAIRS)]
    for name in names:
        got = read_png(str(bench_runs["port"] / name)).astype(int)
        want = read_png(str(bench_runs["jax"] / name)).astype(int)
        assert got.shape == want.shape == (S, S, 3)
        assert np.abs(got - want).max() <= 1, name
    for log, k in ((bench_runs["jax_log"], "jax"), (bench_runs["port_log"], "port")):
        assert f"saved {N_PAIRS} swapped images to {bench_runs[k]}" in log


def test_swap_one_matches_jax(inputs):
    """``swap_one`` (align, parse, keep-masks, CLIP of the masked source,
    landmarks, the swap on JAX's x_T, the background trick, paste-back) on a
    96^2 target and a 64^2 source: within 1e-4 of JAX's in the mean, 1e-2 at
    most; the result differs from the target inside the face."""
    from vface_tpu.pipelines.image_swap import ImageSwapOptions as JOptions
    from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.image_swap import ImageSwapOptions
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import from_flax_aux, from_flax_params

    jax_one = _jax_cli("one_inference")
    target, source = _faces(1, 96, 95)[0], _faces(1, 64, 96)[0]
    jpipe = JPipeline(inputs["jm"], JSwapOptions(image_size=S, parser_size=64))
    want = jax_one.swap_one(jpipe, inputs["jm"], inputs["params"], inputs["jaux"], target, source,
                            JOptions(2, 3.5, S))
    model = VFaceModel(ModelConfig.tiny(image_size=S), device="cpu", conditioner=True)
    model.load_params(from_flax_params(np_tree(inputs["params"])))
    pipe = VideoSwapPipeline(model, SwapOptions(image_size=S, parser_size=64), device="cpu",
                             aux_params=from_flax_aux(np_tree(inputs["jaux"])))
    got = port_one.swap_one(pipe, target, source, ImageSwapOptions(2, 3.5, S), noise=jax_x_T())
    assert got.shape == want.shape == (96, 96, 3)
    diff = np.abs(got - np.asarray(want))
    print(f"swap_one: mean {diff.mean():.3e}, max {diff.max():.3e}")
    assert diff.mean() <= 1e-4 and diff.max() <= 1e-2
    assert np.abs(got - target).max() > 0.05


def _one_argv(d, target, source, out, *extra):
    return ["--target", str(target), "--source", str(source), "--out", str(out), "--tiny", *STEPS, *extra]


def test_one_inference_names_and_watermark(inputs, capsys):
    """The single-image mode writes ``--out``, with ``--watermark`` a payload
    that reads back from the PNG; the folder mode writes every
    ``<source>_to_<target>.png`` (2 targets x 1 source here)."""
    d = inputs["d"] / "one"
    (d / "targets").mkdir(parents=True)
    (d / "sources").mkdir()
    for i, img in enumerate(_faces(2, 96, 97)):
        write_png(str(d / "targets" / f"tar{i}.png"), _u8(img))
    write_png(str(d / "sources" / "me.png"), _u8(_faces(1, 64, 98)[0]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFACE_PLATFORM", "cpu")
        assert port_one.main(_one_argv(d, d / "targets" / "tar0.png", d / "sources" / "me.png", d / "o.png",
                                       "--watermark")) == 0
        assert port_one.main(_one_argv(d, d / "targets", d / "sources", d / "folder")) == 0
    out = read_png(str(d / "o.png"))
    assert out.shape == (96, 96, 3)
    assert port_wm.extract_watermark(out) == port_wm.DEFAULT_PAYLOAD
    assert sorted(os.listdir(d / "folder")) == ["me_to_tar0.png", "me_to_tar1.png"]
    log = capsys.readouterr().out
    assert f"[done] {d / 'o.png'}" in log and "[done] me_to_tar0.png" in log and "[done] me_to_tar1.png" in log


@pytest.mark.parametrize("shape,payload", [((96, 96, 3), port_wm.DEFAULT_PAYLOAD), ((64, 128, 3), b"vface"),
                                           ((120, 72, 3), b"\x00\xffpayload")])
def test_watermark_is_bit_equal_to_jax(shape, payload):
    """``embed_watermark`` equals JAX's bit for bit on the same uint8 image,
    ``extract_watermark`` reads the payload back from both, and the mark
    moves the blue channel only; an image too small raises in both."""
    from vface_tpu.utils import watermark as jax_wm

    img = (np.random.default_rng(len(payload)).uniform(size=shape) * 255).astype(np.uint8)
    got, want = port_wm.embed_watermark(img, payload), jax_wm.embed_watermark(img, payload)
    np.testing.assert_array_equal(got, want)
    assert port_wm.extract_watermark(got, len(payload)) == jax_wm.extract_watermark(want, len(payload)) == payload
    np.testing.assert_array_equal(got[..., :2], img[..., :2])
    with pytest.raises(ValueError, match="too small"):
        port_wm.embed_watermark(img[:32, :32], payload)
    with pytest.raises(ValueError, match="too small"):
        jax_wm.embed_watermark(img[:32, :32], payload)


def _safety_tree(seed: int):
    """A seeded safety-checker tree for the tiny CLIP tower (width 64, 16-d
    projection, 3 concepts, 2 special-care concepts), thresholds zero."""
    from vface_tpu.models.clip import CLIPVisionConfig, CLIPVisionTower

    cfg = CLIPVisionConfig.tiny()
    r = np.random.default_rng(seed)
    return cfg, {"clip": seeded_flax_params(CLIPVisionTower(cfg), jnp.zeros((1, 32, 32, 3)), seed=seed),
                 "visual_projection": (r.normal(size=(64, 16)) / 8).astype(np.float32),
                 "concept_embeds": r.normal(size=(3, 16)).astype(np.float32),
                 "concept_thresholds": np.zeros(3, np.float32),
                 "special_care_embeds": r.normal(size=(2, 16)).astype(np.float32),
                 "special_care_thresholds": np.zeros(2, np.float32)}


def test_safety_checker_flags_match_jax():
    """The first concept's threshold halfway between the middle two images'
    cosines (two of four images past it; round-off cannot decide), the
    others out of reach: the port's flags equal JAX's, and the flagged images
    come back black, the others as they were. Then the special-care concepts
    set the same way (their 0.01 stricter bar) and an adjustment of 0.02:
    the flags equal JAX's."""
    from vface_tpu.models.clip import clip_preprocess
    from vface_tpu.utils.watermark import SafetyChecker as JSafetyChecker
    from vface_torch.models.clip import CLIPVisionConfig
    from vface_torch.utils.convert import from_flax_safety

    cfg, tree = _safety_tree(99)
    images = _faces(4, 48, 100)
    jcheck = JSafetyChecker(cfg)
    pooled = np.asarray(jcheck.tower.apply({"params": tree["clip"]}, clip_preprocess(jnp.asarray(images), 32)))
    emb = pooled @ tree["visual_projection"]
    mid = lambda embeds: (lambda c: ((c[1] + c[2]) / 2).astype(np.float32))(
        np.sort(JSafetyChecker._cos(None, emb, tree[embeds]), axis=0))
    tree["concept_thresholds"] = np.where(np.arange(3) == 0, mid("concept_embeds"), 2.0).astype(np.float32)
    tree["special_care_thresholds"] = np.full(2, 2.0, np.float32)
    check = port_wm.SafetyChecker(CLIPVisionConfig.tiny(), device="cpu")
    want_img, want = jcheck.check(tree, images)
    got_img, got = check.check(from_flax_safety(np_tree(tree)), images)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 2
    assert (got_img[got] == 0).all()
    np.testing.assert_array_equal(got_img[~got], images[~got])
    np.testing.assert_array_equal(np.asarray(want_img), got_img)
    tree["special_care_thresholds"] = mid("special_care_embeds")
    for adjustment in (0.0, 0.02):
        _, want = jcheck.check(tree, images, adjustment)
        _, got = check.check(from_flax_safety(np_tree(tree)), images, adjustment)
        np.testing.assert_array_equal(got, want)


def test_one_inference_blacks_out_flagged_output(inputs):
    """``--safety_params`` from a seeded checker whose thresholds flag
    everything: the output is black, and the CLI says so."""
    from vface_tpu.runtime.checkpoint import save_params_npz

    d = inputs["d"] / "safety"
    d.mkdir()
    _, tree = _safety_tree(101)
    tree["concept_thresholds"] = np.full(3, -2.0, np.float32)
    save_params_npz(str(d / "safety.npz"), tree)
    write_png(str(d / "t.png"), _u8(_faces(1, 64, 102)[0]))
    write_png(str(d / "s.png"), _u8(_faces(1, 64, 103)[0]))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("VFACE_PLATFORM", "cpu")
        assert port_one.main(_one_argv(d, d / "t.png", d / "s.png", d / "o.png", "--safety_params",
                                       str(d / "safety.npz"))) == 0
    assert not read_png(str(d / "o.png")).any()
    assert "[safety]" in out.getvalue()


@pytest.mark.parametrize("cli", [port_bench, port_one], ids=["inference_test_bench", "one_inference"])
def test_cli_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch, cli):
    """Without ``VFACE_PLATFORM=cpu`` each CLI runs on CUDA, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = (["--src_dir", str(tmp_path), "--tar_dir", str(tmp_path), "--tiny"] if cli is port_bench
            else ["--target", str(tmp_path), "--source", str(tmp_path), "--tiny"])
    monkeypatch.delenv("VFACE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    monkeypatch.setenv("VFACE_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VFACE_PLATFORM"):
        cli.main(argv)
