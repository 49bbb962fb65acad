"""The schedulers of the port's ``swap_video_frames``: pipelined packs, the
super-pack (with merged sampling) and its streaming form, against JAX's
sequential loop and the port's own.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner included, from
seeded numpy: no JAX init is compiled), fp32 on the CPU, ``SwapOptions(
ddim_steps=2, inversion_steps=2, window=3, image_size=32, parser_size=64,
raft_iters=2, flow_tokens=256)``, so that FGATS engages at the tiny latent's
16^2 tokens. The clip is the JAX package's ``fgats_clip_baseline``
(``tests/test_pipeline_e2e.py``): 10 frames of 48 x 64 at window 3, three
full packs and a 1-frame remainder, with precomputed keep-masks. JAX runs
twice, each once per module: its sequential loop on the clip and
``vface_sample_pipelined``.

Limits: the pipelined sampler within 1e-5 of the peak of each output of JAX's
(fp32 round-off over four UNet evals; the random-weight UNet's epsilon at
CFG 3 drives the latents to |12|, and the round-off grows with them); each
scheduler within 1e-4 of JAX's sequential loop (as the port's loop itself,
``test_torch_video.py``) and within 2e-5 of the port's (the JAX package's
limit for the same claim, ``tests/test_pipeline_e2e.py``). The streaming form
detects landmarks per group: the CPU's landmark net moves by ~1e-5 px with
its batch, and the frames by up to ~4e-5, so it is held within 1e-4 of a
loop that detects them on the whole clip at once, and equal to one that
detects them in the same batches.
"""

import os

import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t, tiny_video_bundle
from vface_torch.io.image import write_png
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.pipelines import video_swap as TVS
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
from vface_torch.runtime.checkpoint import VideoProgressManifest
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import vface_sample, vface_sample_pipelined

S, H, W, N = 32, 48, 64, 10
OPTS = dict(ddim_steps=2, inversion_steps=2, window=3, image_size=S, parser_size=64, raft_iters=2, flow_tokens=256)
SCHEDULERS = {"pipeline_packs": dict(pipeline_packs=True), "super_pack": dict(invert_packs=2),
              "super_pack_merged": dict(invert_packs=2, merge_sampling=True)}
# the method each scheduler runs instead of the sequential loop
PROGRAM = {"pipeline_packs": "_pipelined_step", "super_pack": "_superpack", "super_pack_merged": "_superpack"}


@pytest.fixture(scope="module")
def bundle():
    return tiny_video_bundle(N + 1, seed=61, s=S, hw=(H, W))


def _pipe(bundle, **fields):
    return VideoSwapPipeline(bundle["model"], SwapOptions(**{**OPTS, **fields}), device="cpu",
                             aux_params=bundle["aux"])


def _spy(pipe, name):
    """Count the calls of one of the pipeline's methods."""
    calls = []
    real = getattr(pipe, name)
    setattr(pipe, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def _swap(bundle, pipe, n=N, **kw):
    return pipe.swap_video_frames(bundle["frames"][:n], bundle["source"], frame_keep=bundle["keep"][:n],
                                  source_keep=bundle["keep"][0], **kw)


@pytest.fixture(scope="module")
def jax_seq(bundle):
    """JAX's sequential loop on the clip."""
    from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline

    jpipe = JPipeline(bundle["jm"], JSwapOptions(**OPTS))
    return np.asarray(jpipe.swap_video_frames(bundle["params"], bundle["jaux"], bundle["frames"][:N],
                                              bundle["source"], frame_keep=bundle["keep"][:N],
                                              source_keep=bundle["keep"][0]))


@pytest.fixture(scope="module")
def seq(bundle):
    """The port's sequential loop on the clip."""
    return _swap(bundle, _pipe(bundle))


# ------------------------------------------------------------ the sampler
F, G, HL, D = 3, 2, 16, 64


def _sampler_inputs():
    r = np.random.default_rng(70)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    return dict(x_T=n(F, HL, HL, 4), cond=n(F, 1, D), uncond=n(F, 1, D), inpaint=n(F, HL, HL, 4),
                mask=r.uniform(size=(F, HL, HL, 1)).astype(np.float32), next_z0=n(G, HL, HL, 4),
                next_cond=n(G, 1, D), next_inpaint=n(G, HL, HL, 4),
                next_mask=r.uniform(size=(G, HL, HL, 1)).astype(np.float32), flow=n(F - 1, HL, HL, 2, scale=1.5),
                pair_mask=np.asarray([1.0, 0.0], np.float32))


def _pipelined(fn, model, x, injection, **kw):
    """``vface_sample_pipelined`` on four sampling and three inversion steps (frozen at the fourth)."""
    return fn(model, *kw.pop("lead", ()), x["x_T"], x["cond"], x["uncond"], x["inpaint"], x["mask"], injection,
              next_z0=x["next_z0"], next_cond=x["next_cond"], next_inpaint=x["next_inpaint"],
              next_mask=x["next_mask"], inversion_steps=4, skip_last=1, flow=x["flow"], num_steps=4,
              cfg_scale=3.0, flow_pair_mask=x["pair_mask"])


def _port_pipelined(bundle):
    x = {k: t(v) for k, v in _sampler_inputs().items()}
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=HL * HL))
    with torch.inference_mode():
        return x, inj, _pipelined(vface_sample_pipelined, bundle["model"], x, inj)


def test_pipelined_sampler_matches_jax(bundle):
    """``vface_sample_pipelined`` (2 sampling rows per frame with FGATS on a
    pair-masked flow, 2 bystander inversion rows): z0, the pred_x0 trajectory
    and the next pack's start code within 1e-5 of the peak of JAX's."""
    from vface_tpu.models.unet import InjectionSpec as JInjectionSpec
    from vface_tpu.ops.attention import FusionConfig as JFusionConfig
    from vface_tpu.samplers.vface import vface_sample_pipelined as jax_pipelined

    jinj = JInjectionSpec(input_blocks=JFusionConfig("flow_fix", flow_tokens=HL * HL))
    want = np_tree(_pipelined(jax_pipelined, bundle["jm"], _sampler_inputs(), jinj, lead=(bundle["params"],)))
    _, _, got = _port_pipelined(bundle)
    assert tuple(got[1].shape) == (4, F, HL, HL, 4) and tuple(got[2].shape) == (G, HL, HL, 4)
    for g, w in zip(got, want):
        close(g, w, atol=1e-5 * float(np.abs(w).max()))


def test_pipelined_sampler_equals_its_parts(bundle):
    """The same call against the port's ``vface_sample(drop_recon_chunk=True)``
    for the sampling rows and ``ddim_invert(skip_last=1)`` for the inversion
    rows, run apart: within 2e-5, so the bystander rows take no fusion."""
    x, inj, got = _port_pipelined(bundle)
    model = bundle["model"]
    with torch.inference_mode():
        z0, traj = vface_sample(model, x["x_T"], x["cond"], x["uncond"], x["cond"], None, x["inpaint"], x["mask"],
                                inj, flow=x["flow"], num_steps=4, cfg_scale=3.0, drop_recon_chunk=True,
                                flow_pair_mask=x["pair_mask"])
        x_T, _ = ddim_invert(model, x["next_z0"], x["next_cond"], x["next_inpaint"], x["next_mask"], num_steps=4,
                             keep=1, skip_last=1)
    for g, w in zip(got, (z0, traj, x_T)):
        close(g, w, atol=2e-5)


# ------------------------------------------------------------ the clip
@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_the_sequential_loop(bundle, jax_seq, seq, name):
    """Each scheduler on the clip (its own program, the packs around it and the
    remainder) within 1e-4 of JAX's sequential loop and 2e-5 of the port's."""
    pipe = _pipe(bundle, **SCHEDULERS[name])
    ran = _spy(pipe, PROGRAM[name])
    timings = {}
    got = _swap(bundle, pipe, timings=timings)
    assert tuple(got.shape) == (N, H, W, 3)
    assert len(ran) == (2 if name == "pipeline_packs" else 1)  # packs 0 and 1 fused; one pair of packs
    assert ("pipelined" in timings) == (name == "pipeline_packs")
    close(got, jax_seq, atol=1e-4)
    close(got, seq, atol=2e-5)


def test_unmasked_pack_boundary_misses_the_limit(bundle, seq, monkeypatch):
    """The merged super-pack with every pair mask forced to ones: the blend
    crosses the boundary between its two packs, and their frames move by far
    more than the 2e-5 the masked run keeps: the mask carries the result."""
    monkeypatch.setattr(TVS, "pack_pair_mask", lambda nf, window: np.ones((nf - 1,), np.float32))
    leaky = _swap(bundle, _pipe(bundle, **SCHEDULERS["super_pack_merged"]))
    assert float((leaky - seq).abs().max()) > 100 * 2e-5


STREAM = dict(window=2, batch_windows=2, invert_packs=2)


def test_streaming_equals_the_super_pack(bundle):
    """Streaming (numpy frames, with the parser) against the super-pack loop
    (tensor frames) on 11 frames at window 2, ``batch_windows=2``: one group
    of two 4-frame packs, then a 3-frame pack. The streaming form detects
    landmarks per group (8 frames, then 3) and the loop on all 11 at once;
    the CPU's landmark net moves by ~1e-5 px with the batch, so the frames
    are held within 1e-4. With the loop's landmarks run in the same batches
    the two are equal."""
    frames = bundle["frames"]
    pipe = _pipe(bundle, **STREAM)
    streamed = _spy(pipe, "_swap_frames_superpacked_streaming")
    superpacks = _spy(pipe, "_superpack")
    got = pipe.swap_video_frames(frames, bundle["source"])
    assert len(streamed) == 1 and len(superpacks) == 1
    plain = pipe.swap_video_frames(torch.from_numpy(frames), bundle["source"])
    assert len(streamed) == 1 and len(superpacks) == 2
    close(got, plain, atol=1e-4)
    real = pipe.detect_landmarks
    pipe.detect_landmarks = lambda x: (torch.cat([real(x[:8]), real(x[8:])]) if x.shape[0] == N + 1 else real(x))
    plain = pipe.swap_video_frames(torch.from_numpy(frames), bundle["source"])
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


# ------------------------------------------------------- manifest, resume
def _sink_to(dirpath, log):
    os.makedirs(dirpath, exist_ok=True)

    def sink(s0, frames):
        paths = []
        for j, fr in enumerate(frames):
            paths.append(os.path.join(dirpath, f"{s0 + j}.png"))
            write_png(paths[-1], (np.clip(fr, 0, 1) * 255).astype(np.uint8))
        log.append((s0, len(frames)))
        return paths
    return sink


@pytest.mark.parametrize("name", ["pipeline_packs", "super_pack", "streaming"])
def test_scheduler_marks_packs_and_resumes(bundle, tmp_path, name):
    """Through a manifest and a window_sink each scheduler sinks and marks
    its packs in order, one entry per pack, and returns the frames of its run
    without them. A run resumed from the manifest with its first pack alone
    takes the sequential loop (JAX's eligibility) and gives the uninterrupted
    frames: the first pack as its PNGs, the rest within 2e-5 (streaming: 1e-4,
    the loop detecting landmarks on the whole clip)."""
    fields = STREAM if name == "streaming" else {**SCHEDULERS[name], "window": 3}
    n = N + 1 if name == "streaming" else N
    w = fields["window"] * fields.get("batch_windows", 1)
    kw = {} if name == "streaming" else dict(frame_keep=bundle["keep"][:n], source_keep=bundle["keep"][0])
    run = lambda pipe, **more: pipe.swap_video_frames(bundle["frames"][:n], bundle["source"], **kw, **more)
    free = run(_pipe(bundle, **fields))
    log = []
    path = str(tmp_path / "m.json")
    marked = run(_pipe(bundle, **fields), manifest=VideoProgressManifest(path),
                 window_sink=_sink_to(tmp_path / "frames", log))
    starts = list(range(0, n, w))
    assert log == [(s0, min(w, n - s0)) for s0 in starts]
    np.testing.assert_array_equal(marked.numpy(), free.numpy())
    manifest = VideoProgressManifest(path)
    assert all(manifest.is_done(s0) for s0 in starts)
    for s0 in starts[1:]:
        manifest.data["windows"].pop(str(s0))
    pipe = _pipe(bundle, **fields)
    skipped = [_spy(pipe, m) for m in ("_superpack", "_pipelined_step", "_swap_frames_superpacked_streaming")]
    resumed = run(pipe, manifest=manifest, window_sink=_sink_to(tmp_path / "frames", []))
    assert not any(skipped)
    u8 = (np.clip(free[:w].numpy(), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(resumed[:w].numpy(), u8.astype(np.float32) / 255.0)
    close(resumed[w:], free[w:], atol=1e-4 if name == "streaming" else 2e-5)
