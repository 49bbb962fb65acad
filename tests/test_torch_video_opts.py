"""``SwapOptions.eta`` and ``SwapOptions.encoder_interval`` through the port's
``swap_video_frames``, against the JAX package's.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner included, from
seeded numpy: no JAX init is compiled), fp32 on the CPU, ``SwapOptions(
ddim_steps=4, inversion_steps=4, window=3, image_size=32, parser_size=64,
raft_iters=2, flow_tokens=256)``: FGATS engages at the tiny latent's 16^2
tokens, and with ``encoder_interval=2`` the third sampling step runs on the
cache while the inversion's first step (of three, ``skip_last=1``) is no key
step and runs on a cache of zeros, as the JAX package's does. The clip: 6
frames of 48 x 64 at window 3 (two windows, or one super-pack), with
precomputed keep-masks. JAX draws each sampler call's noise from
``PRNGKey(0)``; the port's pipeline is handed a source replaying those draws.

Limit: 1e-4 of JAX's frames in [0, 1] (as the exact loop, ``test_torch_video.py``).
"""

import numpy as np
import pytest

from _torch_port import close, jax_noise, tiny_video_bundle
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

S, H, W, N = 32, 48, 64, 6
OPTS = dict(ddim_steps=4, inversion_steps=4, window=3, image_size=S, parser_size=64, raft_iters=2, flow_tokens=256)
RUNS = {
    "sequential_interval2": dict(encoder_interval=2),
    "super_pack_merged_interval2": dict(encoder_interval=2, invert_packs=2, merge_sampling=True),
    "sequential_eta": dict(eta=0.5),
}


@pytest.fixture(scope="module")
def bundle():
    return tiny_video_bundle(N, seed=101, s=S, hw=(H, W))


def _pipe(bundle, **fields):
    return VideoSwapPipeline(bundle["model"], SwapOptions(**{**OPTS, **fields}), device="cpu",
                             aux_params=bundle["aux"], noise=jax_noise())


def _swap(bundle, pipe):
    return pipe.swap_video_frames(bundle["frames"], bundle["source"], frame_keep=bundle["keep"],
                                  source_keep=bundle["keep"][0])


def _jax_swap(bundle, **fields):
    from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline

    jpipe = JPipeline(bundle["jm"], JSwapOptions(**OPTS, **fields))
    return jpipe.swap_video_frames(bundle["params"], bundle["jaux"], bundle["frames"], bundle["source"],
                                   frame_keep=bundle["keep"], source_keep=bundle["keep"][0])


@pytest.fixture(scope="module")
def exact(bundle):
    return _swap(bundle, _pipe(bundle))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_options_match_jax(bundle, exact, run):
    """The sequential loop at ``encoder_interval=2`` and at ``eta=0.5``, and the
    super-pack with merged sampling (one b = 12 sampling batch, the pack
    boundary pair-masked) at ``encoder_interval=2``: within 1e-4 of JAX's
    frames, and away from the exact loop's."""
    pipe = _pipe(bundle, **RUNS[run])
    calls = []
    real = pipe._superpack
    pipe._superpack = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    got = _swap(bundle, pipe)
    assert len(calls) == int(run.startswith("super_pack"))
    close(got, np.asarray(_jax_swap(bundle, **RUNS[run])), atol=1e-4)
    assert float((got - exact).abs().max()) > 1e-3


def test_pipeline_packs_fall_back_with_the_cache(bundle):
    """``pipeline_packs`` needs ``encoder_interval == 1`` in the JAX package's
    eligibility test: at 2 the sequential loop runs, in the port as in JAX."""
    pipe = _pipe(bundle, pipeline_packs=True, encoder_interval=2)
    calls = []
    real = pipe._pipelined_step
    pipe._pipelined_step = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    got = _swap(bundle, pipe)
    assert not calls
    np.testing.assert_array_equal(got.numpy(), _swap(bundle, _pipe(bundle, encoder_interval=2)).numpy())


def test_carry_with_the_cache_is_refused_as_in_jax(bundle):
    """``cross_window_carry`` with ``encoder_interval=2``: JAX's sampler cannot
    join a cached step's empty carry to a key step's in its ``lax.cond`` and
    raises; the port refuses the same call."""
    with pytest.raises(TypeError, match="same pytree structure"):
        _jax_swap(bundle, cross_window_carry=True, encoder_interval=2)
    with pytest.raises(ValueError, match="encoder_interval"):
        _swap(bundle, _pipe(bundle, cross_window_carry=True, encoder_interval=2))
