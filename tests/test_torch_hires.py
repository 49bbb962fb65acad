"""SD-v1 above 512^2: the attention at ds4's head width 160 against the JAX package.

SD-v1's ds4 self-attention (C 1280, 8 heads: dh 160) has 576 tokens at 768^2
and 1024 at 1024^2, where both packages send it to flash attention (N >= 512).
On the card the port runs its hand-written kernels at dh 160
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s phase hires); here, on the
CPU, where the wrappers take their plain versions, those are held to the JAX
package's Pallas kernels in interpret mode at dh 160, with inputs from numpy
seeds: K1 and K4 (``flash_attention_v5``, ``_flash_v5_stats``), the VJP (K4
forward, K6 + K5 backward) against ``jax.vjp``, the fp32 forms against K8
(``flash_attention``), the ragged N = 576 where the UNet's JAX call falls back
to ``multi_head_attention``; a narrow UNet with SD-v1's ds4 geometry at
latents 96^2 and 128^2; and ``swap_image_batch`` at
``ModelConfig.tiny(image_size=64)``.

JAX's blocks are 128 queries by 64 keys, the port's key tiles, so that at
bf16 P is rounded against the same running maxima on both sides.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_bundle_params, seeded_flax_params, t
from vface_tpu.ops.attention import multi_head_attention as jax_mha
from vface_tpu.ops.pallas_attention import (
    _flash_v2_stats, _flash_v5_stats, flash_attention as jax_flash_v1, flash_attention_v5,
)
from vface_torch.ops import flash_attention as FA

BF16 = ml_dtypes.bfloat16
H, DH = 2, 160  # ds4's head width; 2 heads keep the CPU's work small
BLOCKS = (128, 64)


def _inputs(n, dtype, seed, count=3, b=1):
    """Seeded normal arrays (b, n, H*DH): numpy in ``dtype`` and the same values as torch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.normal(size=(b, n, H * DH)).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(BF16)
            out.append((a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)))
        else:
            out.append((a, t(a)))
    return out


def _ulps(want, count):
    """``count`` bf16 ulps at the peak of |want|."""
    peak = float(np.abs(np.asarray(want, np.float32)).max())
    return count * 2.0 ** (math.floor(math.log2(peak)) - 7)


def _tol(dtype, want):
    """fp32: 1e-5 (sums in another order); bf16: 2 ulps of the peak (both round
    the same fp32 values; another order may flip one rounding of P or of the output)."""
    return 1e-5 if dtype == "float32" else _ulps(want, 2)


# ------------------------------------------------------------------- K1, K4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_and_k4_plain_versions_match_flash_v5_at_dh160(dtype):
    """(1, 512, 320), 2 heads: K1's and K4's plain versions against
    flash_attention_v5 and _flash_v5_stats in interpret mode; m (the exact row
    max) and l (its fp32 sum in another order) within 1e-5 relative. The
    wrapper on a CPU tensor is the plain version, bit for bit."""
    (qn, q), (kn, k), (vn, v) = _inputs(512, dtype, seed=160)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    want = flash_attention_v5(jq, jk, jv, H, *BLOCKS, interpret=True)
    got = FA.flash_attention_ref(q, k, v, H)
    assert got.dtype == q.dtype and torch.equal(got, FA.flash_attention(q, k, v, H))
    close(got, np.asarray(want, np.float32), atol=_tol(dtype, want))
    want, wm, wl = _flash_v5_stats(jq, jk, jv, H, *BLOCKS, True)
    got, m, l = FA.flash_attention_stats_ref(q, k, v, H)
    assert m.shape == (H, 512) == l.shape
    close(got, np.asarray(want, np.float32), atol=_tol(dtype, want))
    close(m, wm, atol=0.0, rtol=1e-5)
    close(l, wl, atol=0.0, rtol=1e-5)


# ------------------------------------------------------------------- K5, K6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_jax_vjp_of_flash_v5_at_dh160(dtype):
    """The differentiable wrapper on the CPU (K4's plain forward, K6's and K5's
    plain backward) against jax.vjp of flash_attention_v5 in interpret mode
    (its custom VJP: the stats forward, the K6 recompute, the Pallas
    backward): the output and each gradient within 1e-5 (fp32) or 2 bf16 ulps
    of its peak; no kernel launch is counted."""
    (qn, q), (kn, k), (vn, v), (gn, g) = _inputs(512, dtype, seed=161, count=4)
    out_j, vjp = jax.vjp(lambda a, b, c: flash_attention_v5(a, b, c, H, *BLOCKS, interpret=True),
                         jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = vjp(jnp.asarray(gn))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(*leaves, H)
    assert out.grad_fn is not None
    out.backward(g)
    assert FA.LAUNCHES == before
    close(out.detach(), np.asarray(out_j, np.float32), atol=_tol(dtype, out_j))
    for leaf, wi in zip(leaves, want):
        assert leaf.grad.dtype == q.dtype
        close(leaf.grad, np.asarray(wi, np.float32), atol=_tol(dtype, wi))


# --------------------------------------------------------------- fp32 forms
def test_fp32_forms_match_k8_at_dh160():
    """K8 (``flash_attention_v1``: JAX's k-tiled flash_attention, interpret
    mode) and the forms the card runs on the tf32 kernel at fp32: K4
    (``flash_attention_stats``), K6 (``flash_attention_fp32``), K7
    (``flash_attention_v2_stats``, against _flash_v2_stats too), within 1e-5;
    m and l within 1e-5 relative."""
    (qn, q), (kn, k), (vn, v) = _inputs(512, "float32", seed=162)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    want = np.asarray(jax_flash_v1(jq, jk, jv, H, 128, 128, interpret=True))
    close(FA.flash_attention_v1(q, k, v, H, 128, 128), want, atol=1e-5)
    out4, m, l = FA.flash_attention_stats(q, k, v, H)
    close(out4, want, atol=1e-5)
    close(FA.flash_attention_fp32(q, k, v, H), want, atol=1e-5)
    out7, m7, l7 = FA.flash_attention_v2_stats(q, k, v, H, 256)
    w7, wm, wl = _flash_v2_stats(jq, jk, jv, H, 128, 256, True)
    close(out7, np.asarray(w7), atol=1e-5)
    for a, b in ((m, wm), (m7, wm), (l, wl), (l7, wl)):
        close(a, b, atol=0.0, rtol=1e-5)


# ------------------------------------------------------------ N = 576 (768^2)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_576_tokens_match_jax_fallback(dtype):
    """At 768^2, ds4 has 576 tokens: the JAX UNet's call (block_q 512) does not
    tile them and falls back to multi_head_attention; the port's flash
    attention (K1 on the card, its plain version here) computes the same
    attention: fp32 within 1e-5, bf16 within 2 ulps of the peak (softmax
    rounded after the normalisation there, before it here)."""
    (qn, q), (kn, k), (vn, v) = _inputs(576, dtype, seed=163, b=2)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    want = flash_attention_v5(jq, jk, jv, H, block_q=512)
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  np.asarray(jax_mha(jq, jk, jv, H, dtype=jq.dtype), np.float32))
    close(FA.flash_attention(q, k, v, H), np.asarray(want, np.float32), atol=_tol(dtype, want))


# ------------------------------------------------------------- narrow UNet
def _narrow_unet_cfgs():
    """SD-v1's ds4 geometry at half its width: 160 -> 320 -> 640 channels
    (GroupNorm's 32 groups need multiples of 32, so not 80 -> 320), attention
    at ds4 only, 4 heads of 160, flash on, fp32."""
    from vface_tpu.models.unet import UNetConfig as JCfg
    from vface_torch.models.unet import UNetConfig

    kw = dict(model_channels=160, num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2, 4),
              num_heads=4, context_dim=64, use_remat=False, use_flash=True)
    return JCfg(**kw, dtype=jnp.float32), UNetConfig(**kw, dtype=torch.float32)


@pytest.mark.parametrize("latent", [96, 128], ids=["768", "1024"])
def test_narrow_unet_with_ds4_at_dh160_matches_jax(latent):
    """The UNet at latents 96^2 and 128^2 (768^2 and 1024^2 images: ds4 has
    576 and 1024 tokens of dh 160), params converted with from_flax_params:
    the port's ds4 self-attention goes to flash_attention at (1, N, 640) with
    4 heads (JAX's to multi_head_attention off the TPU); eps within 1e-4 of
    its peak (fp32 sums in other orders through ~20 layers)."""
    from vface_tpu.models.unet import UNetModel as JUNet
    from vface_torch.models import unet as TU
    from vface_torch.utils.convert import from_flax_params

    jcfg, cfg = _narrow_unet_cfgs()
    rng = np.random.default_rng(latent)
    x = rng.normal(size=(1, latent, latent, 9)).astype(np.float32)
    ts = np.array([501], np.int32)
    ctx = rng.normal(size=(1, 1, 64)).astype(np.float32)
    jnet = JUNet(jcfg)
    params = seeded_flax_params(jnet, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), seed=5)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx)))
    net = TU.UNetModel(cfg)
    net.load_state_dict(from_flax_params(np_tree({"unet": params}))["unet"])
    calls = []
    real = TU.flash_attention

    def spy(q, k, v, heads):
        calls.append((tuple(q.shape), heads))
        return real(q, k, v, heads)

    with mock.patch.object(TU, "flash_attention", spy), torch.no_grad():
        got = net(t(x), t(ts).long(), t(ctx))
    n = (latent // 4) ** 2
    assert calls and set(calls) == {((1, n, 640), 4)}
    close(got, want, atol=1e-4 * float(np.abs(want).max()))


# ------------------------------------------------------------- image swap
def test_swap_image_batch_at_64_matches_jax():
    """swap_image_batch at ModelConfig.tiny(image_size=64) (latent 32^2)
    against JAX's on its x_T (PRNGKey(42)'s first split, as
    tests/test_torch_image.py hands it): the image-size paths (the latent and
    mask sizes follow image_size) agree within 1e-4, in [0, 1]. The tiny
    config's widths are not the card's."""
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.pipelines.image_swap import ImageSwapOptions as JOptions
    from vface_tpu.pipelines.image_swap import swap_image_batch as jax_swap
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.image_swap import ImageSwapOptions, swap_image_batch
    from vface_torch.utils.convert import from_flax_params

    s, b, steps = 64, 1, 2
    jm = JModel(JConfig.tiny(image_size=s))
    params = seeded_bundle_params(jm, seed=164)
    model = VFaceModel(ModelConfig.tiny(image_size=s), device="cpu", conditioner=True)
    model.load_params(from_flax_params(np_tree(params)))
    assert model.cfg.latent_size == 32
    clip = model.cfg.cond.clip.image_size  # the CLIP tower's input side, not the image's
    r = np.random.default_rng(165)
    yy, xx = np.mgrid[:s, :s]
    face = ((yy - s * 0.55) / (s * 0.3)) ** 2 + ((xx - s * 0.5) / (s * 0.24)) ** 2 <= 1.0
    args = [np.tanh(r.normal(size=(b, s, s, 3))).astype(np.float32),
            np.broadcast_to((~face).astype(np.float32)[None, :, :, None], (b, s, s, 1)).copy(),
            r.normal(size=(b, clip, clip, 3)).astype(np.float32), r.uniform(size=(b, s, s, 3)).astype(np.float32),
            (r.uniform(size=(b, 136)) * s).astype(np.float32)]
    want = jax_swap(jm, params, *map(jnp.asarray, args), JOptions(steps, 3.0, s))

    def jax_x_T(idx, shape):
        r_noise, _ = jax.random.split(jax.random.PRNGKey(42))
        return torch.from_numpy(np.array(jax.random.normal(r_noise, shape, jnp.float32)))

    got = swap_image_batch(model, *map(t, args), ImageSwapOptions(steps, 3.0, s), noise=jax_x_T)
    assert tuple(got.shape) == (b, s, s, 3) and float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    close(got, np.asarray(want), atol=1e-4)
