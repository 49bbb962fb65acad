"""The slice as a whole: the port's samplers and ``swap_window`` against JAX's.

Tiny bundle (``ModelConfig.tiny(image_size=32)``: latent 16^2, the ds1 token
grid 16^2 = 256 = ``flow_tokens``, so FSAI and FGATS both engage), fp32 on the
CPU, the same seeded crops, keep-mask, conditioning and flow on both sides.
Tolerance: fp32 round-off through the VAE, 1-2 inversion steps and 2 sampling
steps, atol 1e-4 on latents of |z| ~ 1 and on images in [0, 1].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, port_model, t
from vface_tpu.models.unet import InjectionSpec as JIS
from vface_tpu.ops.attention import FusionConfig as JFC
from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline
from vface_tpu.samplers.inversion import ddim_invert as j_invert
from vface_tpu.samplers.vface import vface_sample as j_sample
from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import vface_sample

F, S, HL = 3, 32, 16


@pytest.fixture(scope="module")
def bundles(tiny_bundle):
    model, params = tiny_bundle
    return model, params, port_model(params)


def _latents(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(F, HL, HL, 4)).astype(np.float32)
    zi = rng.normal(size=(F, HL, HL, 4)).astype(np.float32)
    mask = (rng.uniform(size=(F, HL, HL, 1)) > 0.5).astype(np.float32)
    conds = [rng.normal(size=(F, 1, 64)).astype(np.float32) for _ in range(3)]
    flow = (rng.normal(size=(F - 1, HL, HL, 2)) * 1.5).astype(np.float32)
    return z, zi, mask, conds, flow


@pytest.mark.parametrize("skip_last", [0, 1])
def test_ddim_invert_matches_jax(bundles, skip_last):
    jm, params, tm = bundles
    z, zi, mask, (c, _, _), _ = _latents(1)
    jx, jl = j_invert(jm, params, jnp.asarray(z), jnp.asarray(c), jnp.asarray(zi), jnp.asarray(mask),
                      num_steps=3, keep=2, skip_last=skip_last)
    tx, tl = ddim_invert(tm, t(z), t(c), t(zi), t(mask), num_steps=3, keep=2, skip_last=skip_last)
    # S = 3 does not divide T = 1000: the table has 4 steps ([1, 334, 667, 999])
    assert tuple(tl.shape) == tuple(jl.shape) == (4 - skip_last, 2, HL, HL, 4)
    close(tx, jx, atol=1e-4)
    close(tl, jl, atol=1e-4)


@pytest.mark.parametrize("drop_recon_chunk", [True, False])
def test_vface_sample_matches_jax(bundles, drop_recon_chunk):
    jm, params, tm = bundles
    z, zi, mask, (cond, uncond, tcond), flow = _latents(2)
    inv = np.random.default_rng(3).normal(size=(2, F, HL, HL, 4)).astype(np.float32)
    jinj = JIS(input_blocks=JFC("flow_fix", flow_tokens=HL * HL), chunks=3)
    tinj = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=HL * HL), chunks=3)
    jz, jtraj = j_sample(jm, params, jnp.asarray(z), jnp.asarray(cond), jnp.asarray(uncond),
                         jnp.asarray(tcond), jnp.asarray(inv), jnp.asarray(zi), jnp.asarray(mask),
                         jinj, flow=jnp.asarray(flow), num_steps=2, drop_recon_chunk=drop_recon_chunk)
    tz, ttraj = vface_sample(tm, t(z), t(cond), t(uncond), t(tcond), t(inv), t(zi), t(mask), tinj,
                             flow=t(flow), num_steps=2, drop_recon_chunk=drop_recon_chunk)
    close(tz, jz, atol=1e-4)
    close(ttraj, jtraj, atol=1e-4)


@pytest.mark.parametrize("literal", [False, True])
def test_swap_window_matches_jax(bundles, literal):
    """VideoSwapPipeline.swap_window, port vs JAX, FSAI + FGATS engaged: the
    default recon-free operating point, and the literal reference batches
    (co-inverted source, 3-chunk sampling from the second-to-last latent)."""
    jm, params, tm = bundles
    rng = np.random.default_rng(7)
    crops = rng.uniform(-1, 1, size=(F, S, S, 3)).astype(np.float32)
    keep = np.ones((F, S, S, 1), np.float32)
    keep[:, 8:26, 6:24] = 0.0  # the face region to be swapped
    cond, uncond, inv_cond, cond_src = [rng.normal(size=(F, 1, 64)).astype(np.float32) for _ in range(4)]
    src = rng.uniform(-1, 1, size=(1, S, S, 3)).astype(np.float32)
    src_keep = keep[:1]
    flow = (rng.normal(size=(F - 1, S, S, 2)) * 2).astype(np.float32)
    kw = dict(ddim_steps=2, inversion_steps=2, window=F, image_size=S, flow_tokens=HL * HL,
              co_invert_source=literal, keep_recon_chunk=literal)
    args = (crops, keep, cond, uncond, inv_cond, cond_src, src, src_keep)
    want = JPipeline(jm, JSwapOptions(**kw)).swap_window(params, *map(jnp.asarray, args),
                                                        flow=jnp.asarray(flow))
    timings = {}
    got = VideoSwapPipeline(tm, SwapOptions(**kw), device="cpu").swap_window(
        *map(t, args), flow=t(flow), timings=timings)
    assert got.shape == (F, S, S, 3)
    assert set(timings) == {"encode", "invert", "sample", "decode"}
    close(got, want, atol=1e-4)


def test_entry_points_default_to_cuda():
    """Without CUDA the entry points raise unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VFaceModel(ModelConfig.tiny())
    model = VFaceModel(ModelConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoSwapPipeline(model, SwapOptions(image_size=32))
