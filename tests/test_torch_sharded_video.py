"""The multi-GPU video paths of the port's ``VideoSwapPipeline`` against the JAX package's.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner included, seeded
numpy: no JAX init is compiled), fp32 on the CPU, ``SwapOptions(ddim_steps=2,
inversion_steps=2, window=2, image_size=32, parser_size=64, raft_iters=2,
flow_tokens=256)`` (FGATS engages at the tiny latent's 16^2 tokens). The clip
is 7 frames of 48 x 64: three full windows and a trailing 1-frame window.
Its seed is ``tests/test_torch_sched.py``'s: on another seed's clip (91) one
frame's output moved 1.8e-3 in JAX itself under a 1e-6 change of the input
frames (the random-weight pipeline's amplification), which no 1e-4 limit
between two implementations can hold.
The port runs 2 gloo ranks (``tests/_torch_dist.py``); JAX its mesh of 2
virtual CPU devices.

* ``swap_video_frames_sharded`` (windows dealt over the ranks, precomputed
  keep-masks): rank 0's frames within 1e-4 of JAX's same path and within
  2e-5 of the port's sequential loop (the JAX package's limits for the same
  claims, ``tests/test_pipeline_e2e.py``); rank 1 returns None; the
  manifest and the sink see each window once, on rank 0.
* ``swap_video_frames_frame_sharded`` (each window's 2 frames over the 2
  ranks, the halo between them; the BiSeNet parse, as JAX's path always
  parses): rank 0's frames within 2e-5 of the port's sequential loop. Its
  sampler is held to JAX's ``vface_sample_frame_sharded`` within 1e-4 in
  ``tests/test_torch_frame_sharded.py``; JAX's whole frame-sharded video call
  is not run here: it took 99.7 s on this clip on the CPU (its shard_map
  sampler is not jitted), past a test file's budget.
* ``swap_windows_batched``: 3 windows over 2 ranks against the port's
  ``swap_window`` per window (2e-5) and 2 of them against JAX's (1e-4).
* JAX's eligibility errors, in its order, with its messages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_port import close, np_tree, t, tiny_video_bundle
from vface_torch.parallel import mesh as TM
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

S, H, W, N, RANKS = 32, 48, 64, 7, 2
OPTS = dict(ddim_steps=2, inversion_steps=2, window=2, image_size=S, parser_size=64, raft_iters=2, flow_tokens=256)


def _windows(d: int, n_w: int = 3, f: int = 2):
    r = np.random.default_rng(33)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    return [n(n_w, f, S, S, 3, scale=0.2), np.ones((n_w, f, S, S, 1), np.float32), n(n_w, f, 1, d), n(n_w, f, 1, d),
            n(n_w, f, 1, d), n(n_w, f, 1, d), n(n_w, 1, S, S, 3, scale=0.2), np.ones((n_w, 1, S, S, 1), np.float32),
            n(n_w, f - 1, S, S, 2)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    b = tiny_video_bundle(N, seed=61, s=S, hw=(H, W))
    state = {k: v for k, v in b["model"].state_dict().items()}
    parts = {"unet": {}, "vae": {}, "cond": {}}
    for k, v in state.items():
        top, rest = k.split(".", 1)
        parts[{"conditioner": "cond"}.get(top, top)][rest] = v
    windows = _windows(b["jm"].cfg.unet.context_dim)
    ins = dict(state=parts, aux=b["aux"], opts=OPTS, frames=b["frames"], source=b["source"], keep=b["keep"],
               windows=[t(w) for w in windows])
    outs = run_ranks("sharded_video", RANKS, ins, tmp_path_factory.mktemp("video"))
    return dict(b=b, outs=outs, windows=windows)


def _pipe(b, **fields):
    return VideoSwapPipeline(b["model"], SwapOptions(**{**OPTS, **fields}), device="cpu", aux_params=b["aux"])


def _jax_pipe(b, **fields):
    from vface_tpu.pipelines.video_swap import SwapOptions as JOpts
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipe

    return JPipe(b["jm"], JOpts(**{**OPTS, **fields}))


def _jmesh():
    from vface_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=RANKS)


def test_sharded_windows_match_jax_and_the_loop(setup):
    b, outs = setup["b"], setup["outs"]
    got = outs[0]["sharded"]
    assert outs[1]["sharded"] is None
    assert got.shape == (N, H, W, 3)
    want = np.asarray(_jax_pipe(b).swap_video_frames_sharded(b["params"], b["jaux"], b["frames"], b["source"],
                                                              _jmesh(), frame_keep=b["keep"],
                                                              source_keep=b["keep"][0]))
    close(got, want, atol=1e-4)
    seq = _pipe(b).swap_video_frames(b["frames"], b["source"], frame_keep=b["keep"], source_keep=b["keep"][0])
    close(got, seq.numpy(), atol=2e-5)
    # each window sunk and marked once, in window order, on rank 0 only
    assert outs[0]["sunk"] == [(0, 2), (2, 2), (4, 2), (6, 1)]
    assert [m[:2] for m in outs[0]["marks"]] == [(0, 2), (2, 2), (4, 2), (6, 1)]
    assert outs[0]["marks"][3][2] == ["6.png"]
    assert outs[1]["sunk"] == [] and outs[1]["marks"] == []


def test_frame_sharded_windows_match_the_loop(setup):
    b, outs = setup["b"], setup["outs"]
    got = outs[0]["frame_sharded"]
    assert outs[1]["frame_sharded"] is None
    close(got, _pipe(b).swap_video_frames(b["frames"], b["source"]).numpy(), atol=2e-5)


def test_windows_batched_deal_matches_jax_and_swap_window(setup):
    b, outs, windows = setup["b"], setup["outs"], setup["windows"]
    for o in outs:  # every rank gets every window
        assert o["windows"].shape == (3, 2, S, S, 3)
    close(outs[1]["windows"], outs[0]["windows"].numpy(), atol=0.0)
    pipe = _pipe(b)
    for i in range(3):
        close(outs[0]["windows"][i], pipe.swap_window(*(t(w[i]) for w in windows)).numpy(), atol=2e-5)
    jw = [jnp.asarray(w[:RANKS]) for w in windows]
    want = np.asarray(_jax_pipe(b).swap_windows_batched(b["params"], *jw, mesh=_jmesh()))
    close(outs[0]["windows"][:RANKS], want, atol=1e-4)


BAD = {
    "keep_recon_chunk": dict(keep_recon_chunk=True),
    "cross_window_carry": dict(cross_window_carry=True),
    "batch_windows": dict(batch_windows=2),
    "encoder_interval": dict(encoder_interval=2),
    "window_divides": dict(window=3),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_frame_sharded_eligibility_matches_jax(setup, case):
    """Checked before any work, in JAX's order, with JAX's message."""
    b = setup["b"]
    mesh = TM.Mesh(rank=0, size=RANKS, device=torch.device("cpu"))
    with pytest.raises(ValueError) as terr:
        _pipe(b, **BAD[case]).swap_video_frames_frame_sharded(b["frames"][:1], b["source"], mesh)
    with pytest.raises(ValueError) as jerr:
        _jax_pipe(b, **BAD[case]).swap_video_frames_frame_sharded(b["params"], b["jaux"], b["frames"][:1],
                                                                  b["source"], _jmesh())
    assert str(terr.value) == str(jerr.value)
