"""Window packing and the resumable mode of the port's ``swap_video_frames``.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner included; the
JAX init's structure filled with seeded numpy, so no JAX init is compiled),
fp32 on the CPU, ``SwapOptions(ddim_steps=2, inversion_steps=2, window=3,
image_size=32, parser_size=64, raft_iters=2)`` with ``flow_tokens`` = the
latent's 16^2 tokens, so that FGATS engages and the boundary mask carries
the result; precomputed keep-masks (no parser). Frames: 48 x 64, seeded.

Limits: the packed call within 1e-4 of JAX's packed call (fp32 round-off
through the VAE and four UNet evals, as ``test_torch_video.py``), and within
2e-5 of the port's separate windows (the JAX package's own limit for the
same claim, ``tests/test_pipeline_e2e.py::test_batched_windows_match_separate``).
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_port import close, tiny_video_bundle
from vface_torch.io.image import write_png
from vface_torch.pipelines import video_swap as TVS
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
from vface_torch.runtime.checkpoint import VideoProgressManifest

S, H, W = 32, 48, 64
OPTS = dict(ddim_steps=2, inversion_steps=2, window=3, image_size=S, parser_size=64, raft_iters=2,
            flow_tokens=16 * 16)


@pytest.fixture(scope="module")
def bundle():
    return tiny_video_bundle(8, seed=11, s=S, hw=(H, W))


def _pipe(bundle, **fields):
    return VideoSwapPipeline(bundle["model"], SwapOptions(**{**OPTS, **fields}), device="cpu",
                             aux_params=bundle["aux"])


def _swap(bundle, n, pipe=None, **kw):
    pipe = pipe or _pipe(bundle)
    return pipe.swap_video_frames(bundle["frames"][:n], bundle["source"], frame_keep=bundle["keep"][:n],
                                  source_keep=bundle["keep"][0], **kw)


@pytest.fixture(scope="module")
def separate(bundle):
    """The port's window-by-window loop on all 8 frames (windows 0, 3, 6)."""
    return _swap(bundle, 8)


def test_packed_call_matches_jax(bundle):
    """``batch_windows=2`` on 6 frames (one pack of two windows): within 1e-4 of JAX's packed call."""
    from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline

    jpipe = JPipeline(bundle["jm"], JSwapOptions(**OPTS, batch_windows=2))
    kw = dict(frame_keep=bundle["keep"][:6], source_keep=bundle["keep"][0])
    want = np.asarray(jpipe.swap_video_frames(bundle["params"], bundle["jaux"], bundle["frames"][:6],
                                              bundle["source"], **kw))
    got = _swap(bundle, 6, _pipe(bundle, batch_windows=2))
    assert tuple(got.shape) == (6, H, W, 3)
    close(got, want, atol=1e-4)


@pytest.mark.parametrize("n", [6, 8])
def test_packed_call_matches_separate_windows(bundle, separate, n):
    """Packs of two windows (6 frames: one pack; 8 frames: a pack and a
    2-frame tail) equal the separate windows within 2e-5."""
    calls = []
    pipe = _pipe(bundle, batch_windows=2)
    real = pipe.swap_window_pasted
    pipe.swap_window_pasted = lambda *a, **kw: calls.append((a[0].shape[0], kw["pair_mask"])) or real(*a, **kw)
    got = _swap(bundle, n, pipe)
    assert [c[0] for c in calls] == ([6] if n == 6 else [6, 2])
    np.testing.assert_array_equal(np.asarray(calls[0][1]), [1, 1, 0, 1, 1])
    assert all(c[1] is None for c in calls[1:])
    close(got, separate[:n], atol=2e-5)


def test_pack_without_the_boundary_mask_differs(bundle, separate, monkeypatch):
    """With the boundary mask forced to ones the blend crosses the window
    boundary and the pack's frames move by more than 1e-6: the mask carries
    the result."""
    monkeypatch.setattr(TVS, "pack_pair_mask", lambda nf, window: np.ones((nf - 1,), np.float32))
    leaky = _swap(bundle, 6, _pipe(bundle, batch_windows=2))
    assert float((leaky - separate[:6]).abs().max()) > 1e-6


def test_flow_runs_in_chunks_of_pairs(bundle):
    """A pack's 7 pairs go through RAFT in chunks of ``RAFT_MAX_PAIRS`` (5 and 2)
    and equal one batch of all 7 (the pairs are independent; fp32 round-off)."""
    pipe = _pipe(bundle)
    crops = pipe.align_crops(bundle["frames"])[0]
    calls = []
    raft = pipe.raft
    pipe.raft = lambda a, b: calls.append(a.shape[0]) or raft(a, b)
    got = pipe.compute_flow(crops)
    assert calls == [TVS.RAFT_MAX_PAIRS, 7 - TVS.RAFT_MAX_PAIRS] and tuple(got.shape) == (7, S, S, 2)
    x = crops * 2 - 1
    with torch.inference_mode():
        close(got, raft(x[1:], x[:-1]), atol=1e-5)


def test_pack_pair_mask():
    np.testing.assert_array_equal(TVS.pack_pair_mask(12, 6), [1] * 5 + [0] + [1] * 5)
    np.testing.assert_array_equal(TVS.pack_pair_mask(8, 3), [1, 1, 0, 1, 1, 0, 1])
    assert TVS.pack_pair_mask(6, 6) is None and TVS.pack_pair_mask(2, 3) is None


@pytest.mark.parametrize("resumed", [False, True])
def test_scheduler_eligibility_uses_the_packed_width(bundle, tmp_path, resumed):
    """``invert_packs=2`` with ``batch_windows=2`` at window 2: on 6 frames
    (fewer than two packs of 4) JAX's super-pack test fails and both run the
    sequential loop; on 8 frames it passes and the super-pack runs, within
    2e-5 of the sequential loop, unless the manifest lists a pack as done (a
    resumed run takes the sequential loop)."""
    pipe = _pipe(bundle, window=2, batch_windows=2, invert_packs=2)
    superpacks = []
    real = pipe._superpack
    pipe._superpack = lambda *a, **kw: superpacks.append(a[2].shape[0]) or real(*a, **kw)
    seq = _pipe(bundle, window=2, batch_windows=2)
    close(_swap(bundle, 6, pipe), _swap(bundle, 6, seq), atol=0)
    assert superpacks == []
    manifest = None
    if resumed:
        manifest = VideoProgressManifest(str(tmp_path / "m.json"))
        ref = _swap(bundle, 6, seq)
        paths = []
        for i, fr in enumerate(ref[:4].numpy()):
            paths.append(str(tmp_path / f"{i}.png"))
            write_png(paths[-1], (np.clip(fr, 0, 1) * 255).astype(np.uint8))
        manifest.mark_done(0, 4, paths)
    out = _swap(bundle, 8, pipe, manifest=manifest)
    assert tuple(out.shape) == (8, H, W, 3)
    assert superpacks == ([] if resumed else [8])
    if not resumed:
        close(out, _swap(bundle, 8, seq), atol=2e-5)


# ------------------------------------------------------------------ resume
def _sink_to(dirpath, fail_at=None, log=None):
    os.makedirs(dirpath, exist_ok=True)

    def sink(s0, frames):
        if s0 == fail_at:
            raise OSError(f"disk full at window {s0}")
        paths = []
        for j, fr in enumerate(frames):
            paths.append(os.path.join(dirpath, f"{s0 + j}.png"))
            write_png(paths[-1], (np.clip(fr, 0, 1) * 255).astype(np.uint8))
        if log is not None:
            log.append(s0)
        return paths
    return sink


def _counting(pipe):
    calls = []
    real = pipe.swap_window_pasted
    pipe.swap_window_pasted = lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw)
    return calls


def _u8(x):
    return (np.clip(np.asarray(x), 0, 1) * 255).astype(np.uint8)


def test_interrupted_run_resumes_to_the_uninterrupted_output(bundle, tmp_path):
    """A sink that raises at window 3 leaves window 0 marked and 3, 6 not; the
    error reaches the caller. The resumed call recomputes windows 3 and 6
    only, marks them in order, and its uint8 frames equal an uninterrupted
    run's (which marks 0, 3, 6 in order)."""
    whole_log = []
    whole_manifest = VideoProgressManifest(str(tmp_path / "whole.json"), meta={"w": 3})
    whole = _swap(bundle, 8, manifest=whole_manifest, window_sink=_sink_to(tmp_path / "whole", log=whole_log))
    assert whole_log == [0, 3, 6]
    with open(tmp_path / "whole.json") as f:
        assert {k: v["frames"] for k, v in json.load(f)["windows"].items()} == {"0": 3, "3": 3, "6": 2}

    path = str(tmp_path / "m.json")
    with pytest.raises(OSError, match="disk full at window 3"):
        _swap(bundle, 8, manifest=VideoProgressManifest(path, meta={"w": 3}),
              window_sink=_sink_to(tmp_path / "frames", fail_at=3))
    manifest = VideoProgressManifest(path, meta={"w": 3})
    assert manifest.is_done(0) and not manifest.is_done(3) and not manifest.is_done(6)

    pipe, log = _pipe(bundle), []
    calls = _counting(pipe)
    resumed = _swap(bundle, 8, pipe, manifest=manifest, window_sink=_sink_to(tmp_path / "frames", log=log))
    assert calls == [3, 2] and log == [3, 6]
    assert all(VideoProgressManifest(path, meta={"w": 3}).is_done(s) for s in (0, 3, 6))
    np.testing.assert_array_equal(_u8(resumed), _u8(whole))
    close(whole, _u8(whole).astype(np.float32) / 255.0, atol=1 / 255)


def test_manifest_without_a_sink_is_read_but_never_marked(bundle, tmp_path):
    """With a manifest and no sink, done windows are read back and the rest
    computed, and nothing is marked; a sink without a manifest is never
    called (both as in the JAX package)."""
    path = str(tmp_path / "m.json")
    manifest = VideoProgressManifest(path)
    _swap(bundle, 6, manifest=manifest, window_sink=_sink_to(tmp_path / "frames"))
    manifest.data["windows"].pop("3")
    manifest.mark_done(0, 3, manifest.data["windows"]["0"]["outputs"])
    before = open(path).read()
    pipe = _pipe(bundle)
    calls = _counting(pipe)
    out = _swap(bundle, 6, pipe, manifest=VideoProgressManifest(path))
    assert calls == [3] and open(path).read() == before and tuple(out.shape) == (6, H, W, 3)
    sunk = []
    _swap(bundle, 3, window_sink=lambda s0, frames: sunk.append(s0))
    assert sunk == []
