"""The port's fusion and warp functions and every ``fuse_qkv`` mode against JAX.

Seeded numpy inputs go through ``vface_tpu.ops`` and ``vface_torch.ops`` alike,
fp32 on the CPU; tolerance 1e-5 (fp32 round-off in another summation order).
Also: the UNet's wide feed-forward takes the unfused path, never the fused
kernel's plain version (a repair), and the cross-window carry, not threaded
through the port's UNet yet, is refused there.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vface_torch.ops as O
from _torch_port import close, t
from vface_tpu.ops import attention as JA
from vface_tpu.ops import fusion as JF
from vface_tpu.ops import warp as JW
from vface_torch.models import unet as unet_mod
from vface_torch.ops import geglu_ff as FF

TOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ fusion
FUSION_CASES = {
    "fft_fusion": (lambda m, a, b: m.fft_fusion(a, b, center=5, center_exclude=1), (2, 16, 12, 3)),
    "gaussian_blur": (lambda m, a, b: m.gaussian_blur(a, 5, 1.3), (2, 10, 9, 4)),
    "gaussian_blur_even": (lambda m, a, b: m.gaussian_blur(a, 4, 0.8), (1, 7, 8, 3)),
    "lpf_fusion": (lambda m, a, b: m.lpf_fusion(a, b, 3, 0.7), (2, 10, 9, 4)),
    "adain_fusion": (lambda m, a, b: m.adain_fusion(a, b, alpha=0.6, beta=1.1), (2, 8, 8, 4)),
    "adain_fusion_unnormalized": (lambda m, a, b: m.adain_fusion(a, b, normalized=False), (2, 8, 8, 4)),
    "adain_fusion_attn": (lambda m, a, b: m.adain_fusion_attn(a, b, alpha=0.9), (4, 64, 32)),
    "adain_fusion_attn_unnormalized": (lambda m, a, b: m.adain_fusion_attn(a, b, 0.9, normalized=False),
                                       (4, 64, 32)),
    "mix": (lambda m, a, b: m.mix(a, b, alpha=0.3), (4, 64, 32)),
    "temporal_gaussian": (lambda m, a, b: m.temporal_gaussian(a, 5, 1.0), (6, 16, 8)),
    "temporal_gaussian_short": (lambda m, a, b: m.temporal_gaussian(a, 3, 0.7), (2, 16, 8)),
}


@pytest.mark.parametrize("name", sorted(FUSION_CASES))
def test_fusion_matches_jax(name):
    fn, shape = FUSION_CASES[name]
    a, b = _rand(*shape, seed=1) + 0.3, _rand(*shape, seed=2, scale=2.0)
    want = fn(JF, jnp.asarray(a), jnp.asarray(b))
    got = fn(O, t(a), t(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want, atol=TOL, rtol=TOL)


# -------------------------------------------------------------------- warp
def _flows(n, h, w, seed):
    return _rand(n, h, w, 2, seed=seed, scale=2.0)


def _codec(m):
    """Stand-ins for decode/encode, written alike in both frameworks."""
    return (lambda z: m.tanh(z) * 2.0), (lambda x: x * 0.5 + 0.1)


WARP_CASES = {
    "align_by_flow_carry": lambda m, x, f, p, f0, pm: m.align_by_flow(x, f, 0.7, p, f0, pm),
    "align_by_flow_carry_only": lambda m, x, f, p, f0, pm: m.align_by_flow(x, f, 0.8, prev0=p, flow0=f0),
    "align_by_flow_chain": lambda m, x, f, p, f0, pm: m.align_by_flow_chain(x, f, 0.6),
    "batch_flow_align_latent": lambda m, x, f, p, f0, pm: m.batch_flow_align_latent(x, f, 0.25),
    "warp_from_video": lambda m, x, f, p, f0, pm: m.warp_from_video(x, f),
}


@pytest.mark.parametrize("name", sorted(WARP_CASES))
def test_warp_matches_jax(name):
    x, flow = _rand(4, 9, 11, 5, seed=3), _flows(3, 9, 11, seed=4)
    prev0, flow0 = _rand(1, 9, 11, 5, seed=5), _flows(1, 9, 11, seed=6)
    pm = np.array([1.0, 0.0, 1.0], np.float32)
    fn = WARP_CASES[name]
    want = fn(JW, *(jnp.asarray(a) for a in (x, flow, prev0, flow0, pm)))
    got = fn(O, *(t(a) for a in (x, flow, prev0, flow0, pm)))
    close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["align_by_flow_high_res", "batch_flow_align"])
def test_pixel_space_align_matches_jax(name):
    """decode, blend with the previous frame's warp (parallel or recurrent), encode."""
    x, flow = _rand(3, 8, 8, 3, seed=7), _flows(2, 8, 8, seed=8)
    dec_j, enc_j = _codec(jnp)
    dec_t, enc_t = _codec(torch)
    want = getattr(JW, name)(jnp.asarray(x), jnp.asarray(flow), dec_j, enc_j, 0.4)
    got = getattr(O, name)(t(x), t(flow), dec_t, enc_t, 0.4)
    close(got, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- fuse_qkv
F = 4  # frames per chunk
BYSTANDER = 2
NEW_MODES = ["replace", "temporal", "adain", "mix", "fft_vfixed", "flow_fix"]


def _qkv(chunks, seed):
    b = chunks * F + BYSTANDER
    return [_rand(b, 64, 32, seed=seed + i) for i in range(3)]


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("mode", NEW_MODES)
def test_fuse_qkv_matches_jax(mode, chunks):
    """Every mode on q/k/v of (chunks * 4 + 2 bystander rows, 64, 32): 2 chunks
    with the recon-free semantics (the fusion applied to chunk 1), 3 chunks
    literal. flow_fix warps the swap chunk on its 8x8 token grid with the
    previous window's carry in and a pair mask, and returns the carry out."""
    q, k, v = _qkv(chunks, seed=10 * chunks)
    kw = dict(flow_tokens=64, bystander=BYSTANDER, two_chunk_replace=False, mix_alpha=0.3, adain_alpha=0.7,
              temporal_window=3, temporal_sigma=0.8)
    flow, flow0 = _flows(F - 1, 8, 8, seed=20), _flows(1, 8, 8, seed=21)
    prev = {"q": _rand(1, 64, 32, seed=22), "k": _rand(1, 64, 32, seed=23)}
    pm = np.array([1.0, 0.0, 1.0], np.float32)
    jq, jk, jv, jc = JA.fuse_qkv(*(jnp.asarray(a) for a in (q, k, v)), JA.FusionConfig(mode, **kw), chunks=chunks,
                                 flow=jnp.asarray(flow), prev_qk={n: jnp.asarray(a) for n, a in prev.items()},
                                 flow0=jnp.asarray(flow0), pair_mask=jnp.asarray(pm))
    tq, tk, tv, tc = O.fuse_qkv(*(t(a) for a in (q, k, v)), O.FusionConfig(mode, **kw), chunks=chunks,
                                flow=t(flow), prev_qk={n: t(a) for n, a in prev.items()}, flow0=t(flow0),
                                pair_mask=t(pm))
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        assert got.dtype == torch.float32
        close(got, want, atol=TOL, rtol=TOL)
    assert (tc is None) == (jc is None) == (mode != "flow_fix")
    if tc is not None:
        close(tc["q"], jc["q"], atol=TOL, rtol=TOL)
        close(tc["k"], jc["k"], atol=TOL, rtol=TOL)
    by = slice(chunks * F, None)  # the bystander rows pass through untouched
    assert torch.equal(tq[by], t(q)[by]) and torch.equal(tv[by], t(v)[by])


@pytest.mark.parametrize("mode", ["fft_vfixed", "flow_fix", "temporal"])
def test_two_chunk_replace_matches_jax(mode):
    """2 chunks with the reference's donor copy: q and k of chunk 1 become chunk
    0's, the carry is dropped, and fft_vfixed still pins v; bf16 in, bf16 out."""
    q, k, v = [a[: 2 * F] for a in _qkv(2, seed=30)]
    cfg = dict(flow_tokens=64)
    flow = _flows(F - 1, 8, 8, seed=31)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = JA.fuse_qkv(bf(q), bf(k), bf(v), JA.FusionConfig(mode, **cfg), chunks=2, flow=jnp.asarray(flow))
    got = O.fuse_qkv(*(t(a).to(torch.bfloat16) for a in (q, k, v)), O.FusionConfig(mode, **cfg), chunks=2,
                     flow=t(flow))
    assert got[3] is None and want[3] is None
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16
        close(g, np.asarray(w, np.float32), atol=0.0)


def test_frame_sharded_form_is_refused():
    """The frame-sharded ``flow_axis`` form is ported (``tests/test_torch_mesh.py``);
    what stays refused, as in JAX, is its 2-chunk donor copy, which would discard the blend."""
    from vface_torch.parallel.mesh import bind_axis, single_device_mesh

    q = t(_rand(2 * F, 64, 32, seed=40))
    flow = t(_rand(F, 8, 8, 2, seed=46))
    with bind_axis("data", single_device_mesh("cpu")), pytest.raises(ValueError, match="flow_axis"):
        O.fuse_qkv(q, q, q, O.FusionConfig("flow_fix", flow_tokens=64, flow_axis="data"), chunks=2, flow=flow)


def test_cross_window_carry_is_refused_by_the_unet():
    """The carry is no longer refused: an attn1 site hands ``FlowPack.prev[site]``
    and ``flow0`` to ``fuse_qkv`` (another site's entry is ignored), and writes
    the carry it returns under its site into ``carry_out``."""
    attn = unet_mod.CrossAttention(32, heads=2)
    x = t(_rand(2 * F, 64, 32, seed=41))
    prev = {"q": t(_rand(1, 64, 32, seed=42)), "k": t(_rand(1, 64, 32, seed=43))}
    flow, flow0 = (t(_rand(F - 1, 8, 8, 2, seed=44)), t(_rand(1, 8, 8, 2, seed=45)))
    pack = O.FlowPack(flow=flow, prev={"in_0_0_attn": prev, "in_0_1_attn": None}, flow0=flow0)
    fusion = O.FusionConfig("flow_fix", flow_tokens=64, two_chunk_replace=False)
    calls = []
    real = unet_mod.fuse_qkv

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    carry_out = {}
    with mock.patch.object(unet_mod, "fuse_qkv", spy):
        attn(x, fusion=fusion, chunks=2, flow=pack, site="in_0_0_attn", carry_out=carry_out)
    assert calls[0]["prev_qk"] is prev and calls[0]["flow0"] is flow0 and calls[0]["flow"] is flow
    q, k = attn.to_q(x), attn.to_k(x)
    want = O.fuse_qkv(q, k, attn.to_v(x), fusion, chunks=2, flow=flow, prev_qk=prev, flow0=flow0)[3]
    assert list(carry_out) == ["in_0_0_attn"]
    for name in ("q", "k"):
        close(carry_out["in_0_0_attn"][name], want[name].detach(), atol=0)


# -------------------------------------------------------------- repair 0a
@pytest.mark.parametrize("grad", [False, True])
def test_wide_feed_forward_takes_the_unfused_path(grad):
    """A FeedForward wider than the fused kernel's 768 (use_fused on, as in
    sd_v1_inpaint) calls geglu_ff_unfused, never the fused kernel's plain
    version, with or without a gradient; it matches JAX's unfused GEGLU."""
    import jax

    from vface_tpu.models.unet import FeedForward as JFeedForward
    from vface_torch.utils.convert import flax_tree_to_state_dict

    c = 800
    ff = unet_mod.FeedForward(c, use_fused=True)
    assert not ff.use_fused
    jff = JFeedForward(c, use_fused=True)
    x = _rand(2, 5, c, seed=50)
    params = jff.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ff.load_state_dict(flax_tree_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    real = unet_mod.geglu_ff_unfused

    def refuse(*args):
        raise AssertionError("the fused kernel's plain version ran")

    with mock.patch.object(FF, "geglu_ff_ref", refuse), mock.patch.object(FF, "_geglu_ff_plain", refuse), \
            mock.patch.object(unet_mod, "geglu_ff", refuse), \
            mock.patch.object(unet_mod, "geglu_ff_unfused", lambda *a: calls.append(1) or real(*a)):
        xt = t(x).requires_grad_(grad)
        got = ff(xt)
        if grad:
            got.sum().backward()
            assert xt.grad is not None
    assert calls == [1]
    close(got, jff.apply({"params": params}, jnp.asarray(x)), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("grad", [False, True])
def test_wide_sites_take_k9_only_without_a_gradient(grad):
    """The UNet's wide widths (C = 1280 at ds4 and in the middle block, with
    use_fused as sd_v1_inpaint sets it) call K9 (geglu_ff_wide, its plain
    version on the CPU) when no gradient is recorded and geglu_ff_unfused when
    one is (JAX defines no VJP for its wide kernel); both compute JAX's
    unfused GEGLU to fp32 round-off."""
    c = 1280
    ff = unet_mod.FeedForward(c, use_fused=True)
    assert ff.use_wide and not ff.use_fused
    rng = np.random.default_rng(51)
    for p in ff.parameters():
        p.data = t(rng.normal(size=p.shape).astype(np.float32) * p.shape[-1] ** -0.5)
    x = t(rng.normal(size=(1, 3, c)).astype(np.float32))
    calls = []
    wide, unfused = unet_mod.geglu_ff_wide, unet_mod.geglu_ff_unfused
    with mock.patch.object(unet_mod, "geglu_ff_wide", lambda *a: calls.append("k9") or wide(*a)), \
            mock.patch.object(unet_mod, "geglu_ff_unfused", lambda *a: calls.append("unfused") or unfused(*a)), \
            torch.set_grad_enabled(grad):
        got = ff(x)
    assert calls == ["unfused" if grad else "k9"]
    w = (ff.geglu.proj.weight, ff.geglu.proj.bias, ff.proj_out.weight, ff.proj_out.bias)
    assert got.requires_grad == grad
    with torch.no_grad():
        close(got, FF.geglu_ff_unfused(x, *w).numpy(), atol=1e-5, rtol=1e-5)


def test_circulant_cache_serves_inference_then_gradient():
    """The FFT fusion's cached circulant, first built under inference mode (as
    swap_window builds it), still serves a call that records a gradient
    (the sampler or the training step on the same width afterwards)."""
    d = 24  # a width no other test builds first
    with torch.inference_mode():
        O.combine_fft_high_low_circulant(torch.ones(1, 2, d), torch.zeros(1, 2, d))
    branch = torch.randn(1, 2, d, requires_grad=True)
    O.combine_fft_high_low_circulant(torch.zeros(1, 2, d), branch).sum().backward()
    assert branch.grad is not None and torch.isfinite(branch.grad).all()


def test_fusion_config_fields_match_jax():
    """The port's FusionConfig has JAX's fields and defaults."""
    want = {f.name: f.default for f in dataclasses.fields(JA.FusionConfig)}
    got = {f.name: f.default for f in dataclasses.fields(O.FusionConfig)}
    assert got == want
    assert O.FlowPack._fields == JA.FlowPack._fields
