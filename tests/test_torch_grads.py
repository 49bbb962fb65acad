"""The training kernels' plain versions and the port's VJPs against the JAX package.

K4 (stats forward), K6 (fp32-P forward) and K5 (backward): each plain version
against its Pallas kernel in interpret mode, as ``tests/test_pallas_attention.py``
runs them; the differentiable wrappers (flash attention, GEGLU FF, GroupNorm
sums) against ``jax.grad`` through the JAX package's custom VJPs. The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import functools
import math
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import close, t
from vface_tpu.models import layers as JL
from vface_tpu.ops.pallas_attention import (
    _flash_v2_impl, _flash_v2_stats, _flash_v5_stats, flash_attention_bwd, flash_attention_v2, flash_attention_v5,
)
from vface_tpu.ops.pallas_ff import geglu_ff as jax_geglu_ff
from vface_torch.models import layers as TL
from vface_torch.ops import flash_attention as FA
from vface_torch.ops import geglu_ff as FF
from vface_torch.ops import gn_sums as GN
from vface_torch.utils.convert import flax_tree_to_state_dict

BF16 = ml_dtypes.bfloat16


def _inputs(n, h, dh, dtype, seed, count=3):
    """Seeded normal arrays (2, n, h*dh): numpy in ``dtype`` and the same values as torch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.normal(size=(2, n, h * dh)).astype(np.float32)
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


# ------------------------------------------------------------------------ K4
@pytest.mark.parametrize("n,dh,blocks", [(256, 40, (128, 64)), (256, 80, (128, 64)), (300, 40, (100, 100))])
def test_stats_ref_matches_pallas_v5_stats(n, dh, blocks):
    """bf16. out: K1's tolerance (atol 1e-2; P is rounded against the running
    max of the block, so other blocks move a bf16 rounding). m is the exact
    row max and l its fp32 sum in another order: 1e-5 relative. N = 300 is
    ragged for the kernels' 64-row tiles (Pallas needs blocks that divide N)."""
    h = 2
    (qn, q), (kn, k), (vn, v) = _inputs(n, h, dh, "bfloat16", seed=dh + n)
    want, wm, wl = _flash_v5_stats(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, *blocks, True)
    got, m, l = FA.flash_attention_stats_ref(q, k, v, h)
    assert got.dtype == torch.bfloat16 and m.shape == (2 * h, n) == l.shape
    close(got, np.asarray(want, np.float32), atol=1e-2)
    close(m, wm, atol=0.0, rtol=1e-5)
    close(l, wl, atol=0.0, rtol=1e-5)
    assert torch.equal(got, FA.flash_attention_ref(q, k, v, h))  # K1's plain version, bit for bit


# ------------------------------------------------------------------------ K6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_ref_matches_pallas_v2(dtype):
    """fp32: round-off (2e-5 abs). bf16 inputs, fp32 math, one rounding of the
    output: 1 bf16 ulp of the output's peak (sums in another order)."""
    h, dh = 2, 40
    (qn, q), (kn, k), (vn, v) = _inputs(256, h, dh, dtype, seed=3)
    want = _flash_v2_impl(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, 128, 128, True)
    got = FA.flash_attention_fp32_ref(q, k, v, h)
    assert got.dtype == q.dtype
    close(got, np.asarray(want, np.float32), atol=2e-5 if dtype == "float32" else _ulps(want, 1))


# ------------------------------------------------------------------------ K5
@pytest.mark.parametrize("dtype,dh", [("float32", 40), ("bfloat16", 40), ("bfloat16", 80)])
def test_bwd_ref_matches_pallas_bwd(dtype, dh):
    """m and l from _flash_v5_stats for both sides; the port recomputes O with
    K6's plain version and D = rowsum(dO*O) as flash_attention_bwd does.
    fp32: 2e-5 abs (as test_pallas_attention.py holds the Pallas backward).
    bf16: 2 bf16 ulps of each gradient's peak."""
    h, n = 2, 256
    (qn, q), (kn, k), (vn, v), (gn, g) = _inputs(n, h, dh, dtype, seed=dh, count=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (qn, kn, vn, gn))
    _, m, l = _flash_v5_stats(jq, jk, jv, h, 128, 64, True)
    want = flash_attention_bwd(jq, jk, jv, m, l, jg, h, block_q=128, block_k=128, interpret=True)
    mt, lt = t(m), t(l)
    dd = FA.rowsum_do_o(g, FA.flash_attention_fp32_ref(q, k, v, h), h)
    got = FA.flash_attention_bwd_ref(q, k, v, g, mt, lt, dd, h)
    for gi, wi in zip(got, want):
        assert gi.dtype == q.dtype
        close(gi, np.asarray(wi, np.float32), atol=2e-5 if dtype == "float32" else _ulps(wi, 2))


@pytest.mark.parametrize("n,h,dh", [(300, 2, 40), (130, 3, 16)])
def test_precision_gate_passes_fp32_p_and_fails_bf16_p(n, h, dh):
    """The card holds K6 and K5 to their fp32 plain versions in relative L2
    error, under a quarter of a yardstick's: the plain version with P (and dS)
    rounded to bf16 alone. The same formulas in float64 (K5's on the same m, l
    and D), rounded once to bf16, stay far under that share; the yardstick is
    at 1 by definition, and it does round (its error is near 2^-9)."""
    gate = 0.25
    (_, q), (_, k), (_, v), (_, g) = _inputs(n, h, dh, "bfloat16", seed=n + dh, count=4)
    rel = lambda a, want: float((a.float() - want.float()).norm() / want.float().norm())
    split = lambda x: x.reshape(2, n, h, dh).transpose(1, 2).double()
    merge = lambda x: x.transpose(1, 2).reshape(2, n, h * dh).to(torch.bfloat16)
    qh, kh, vh, gh = split(q), split(k), split(v), split(g)
    s64 = qh @ kh.transpose(-1, -2) * dh**-0.5

    want6 = FA.flash_attention_fp32_ref(q, k, v, h)
    yard6 = rel(FA.flash_attention_stats_ref(q, k, v, h)[0], want6)
    assert 1e-3 < yard6 < 4e-3
    assert rel(merge(torch.softmax(s64, dim=-1) @ vh), want6) < gate * yard6

    _, m, l = FA.flash_attention_stats_ref(q, k, v, h)
    dd = FA.rowsum_do_o(g, want6, h)
    stat = lambda x: x.reshape(2, h, n, 1).double()
    p64 = torch.exp(s64 - stat(m)) / stat(l)
    ds64 = p64 * (gh @ vh.transpose(-1, -2) - stat(dd))
    exact = (merge(ds64 @ kh * dh**-0.5), merge(ds64.transpose(-1, -2) @ qh * dh**-0.5),
             merge(p64.transpose(-1, -2) @ gh))
    want5 = FA.flash_attention_bwd_ref(q, k, v, g, m, l, dd, h)
    yard5 = FA.flash_attention_bwd_ref(q, k, v, g, m, l, dd, h, round_p=True)
    for ei, wi, yi in zip(exact, want5, yard5):
        assert 1e-3 < rel(yi, wi) < 4e-3
        assert rel(ei, wi) < gate * rel(yi, wi)


@pytest.mark.parametrize("dh", [40, 80])
def test_autograd_matches_jax_grad_of_flash_v5(dh):
    """The differentiable wrapper on the CPU (plain K4 forward, plain K6 + K5
    backward) vs jax.grad of flash_attention_v5 in interpret mode (its custom
    VJP: stats forward, K6 recompute, the Pallas backward), bf16: 2 bf16 ulps
    of each gradient's peak. The forward is K1's plain version bit for bit."""
    h, n = 2, 256
    (qn, q), (kn, k), (vn, v), (gn, g) = _inputs(n, h, dh, "bfloat16", seed=7 + dh, count=4)
    jg = jnp.asarray(gn).astype(jnp.float32)

    def loss(a, b, c):
        out = flash_attention_v5(a, b, c, h, block_q=128, block_k=64, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jg)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(*leaves, h)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), FA.flash_attention_ref(q, k, v, h))
    (out.float() * g.float()).sum().backward()
    assert FA.LAUNCHES == before  # CPU tensors: plain versions, no launch
    for leaf, wi in zip(leaves, want):
        close(leaf.grad, np.asarray(wi, np.float32), atol=_ulps(wi, 2))


# ------------------------------------------------------- Nq != Nk (K5-K7)
# queries over twice as many keys and the reverse; blocks of 128 divide both,
# as JAX's kernels need
CROSS = [(128, 256), (256, 128)]


def _cross(nq, nk, h, dh, dtype, seed):
    """q and dO (2, nq, h*dh), k and v (2, nk, h*dh): numpy in ``dtype`` and torch."""
    (qn, q), (gn, g) = _inputs(nq, h, dh, dtype, seed=seed, count=2)
    (kn, k), (vn, v) = _inputs(nk, h, dh, dtype, seed=seed + 1, count=2)
    return (qn, kn, vn, gn), (q, k, v, g)


@pytest.mark.parametrize("nq,nk", CROSS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_and_v2_stats_refs_match_pallas_at_cross_attention(dtype, nq, nk):
    """K6's and K7's plain versions against _flash_v2_impl and _flash_v2_stats
    (interpret mode) at Nq != Nk, with test_fp32_ref_matches_pallas_v2's
    tolerances: fp32 2e-5 abs, bf16 1 ulp of the output's peak; m and l (the
    exact row max; its fp32 sum) 1e-5 relative."""
    h, dh = 2, 40
    (qn, kn, vn, _), (q, k, v, _) = _cross(nq, nk, h, dh, dtype, seed=11)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    tol = lambda want: 2e-5 if dtype == "float32" else _ulps(want, 1)
    want = _flash_v2_impl(jq, jk, jv, h, 128, 128, True)
    got = FA.flash_attention_fp32_ref(q, k, v, h)
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, np.asarray(want, np.float32), atol=tol(want))
    want, wm, wl = _flash_v2_stats(jq, jk, jv, h, 128, 128, True)
    got, m, l = FA.flash_attention_v2_stats_ref(q, k, v, h)
    assert m.shape == (2 * h, nq) == l.shape
    close(got, np.asarray(want, np.float32), atol=tol(want))
    close(m, wm, atol=0.0, rtol=1e-5)
    close(l, wl, atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("nq,nk", CROSS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_pallas_bwd_at_cross_attention(dtype, nq, nk):
    """K5's plain version against flash_attention_bwd (interpret mode) at
    Nq != Nk: m and l (B*H, Nq) from _flash_v5_stats for both sides, the port's
    D from K6's plain version; test_bwd_ref_matches_pallas_bwd's tolerances
    (fp32 2e-5 abs, bf16 2 ulps of each gradient's peak)."""
    h, dh = 2, 40
    (qn, kn, vn, gn), (q, k, v, g) = _cross(nq, nk, h, dh, dtype, seed=13)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (qn, kn, vn, gn))
    _, m, l = _flash_v5_stats(jq, jk, jv, h, 128, 64, True)
    want = flash_attention_bwd(jq, jk, jv, m, l, jg, h, block_q=128, block_k=128, interpret=True)
    dd = FA.rowsum_do_o(g, FA.flash_attention_fp32_ref(q, k, v, h), h)
    got = FA.flash_attention_bwd_ref(q, k, v, g, t(m), t(l), dd, h)
    for gi, wi, ref in zip(got, want, (q, k, v)):
        assert gi.dtype == q.dtype and gi.shape == ref.shape
        close(gi, np.asarray(wi, np.float32), atol=2e-5 if dtype == "float32" else _ulps(wi, 2))


@pytest.mark.parametrize("nq,nk", CROSS)
def test_autograd_matches_jax_grad_of_flash_v5_at_cross_attention(nq, nk):
    """The differentiable wrapper on the CPU at Nq != Nk (plain K4 forward,
    plain K6 + K5 backward) vs jax.grad of flash_attention_v5 in interpret
    mode, bf16: 2 bf16 ulps of each gradient's peak, as at Nq == Nk."""
    h, dh = 2, 40
    (qn, kn, vn, gn), (q, k, v, g) = _cross(nq, nk, h, dh, "bfloat16", seed=17)
    jg = jnp.asarray(gn).astype(jnp.float32)

    def loss(a, b, c):
        out = flash_attention_v5(a, b, c, h, block_q=128, block_k=64, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jg)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(*leaves, h)
    (out.float() * g.float()).sum().backward()
    assert FA.LAUNCHES == before  # CPU tensors: plain versions, no launch
    for leaf, wi in zip(leaves, want):
        close(leaf.grad, np.asarray(wi, np.float32), atol=_ulps(wi, 2))


# ------------------------------------------------------- fp32 gradients
# (nq, nk, dh, JAX's blocks): the UNet's two head widths, and Nq != Nk ragged
# against the port's 64-row tiles (200 and 100 rows; JAX's blocks must divide N)
FP32_GRAD = [(256, 256, 40, (128, 64)), (256, 256, 80, (128, 64)), (200, 100, 40, (100, 100))]


@pytest.mark.parametrize("nq,nk,dh,blocks", FP32_GRAD)
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_v2"])
def test_fp32_autograd_matches_jax_grad(entry, nq, nk, dh, blocks):
    """The port's flash_attention (v5) and flash_attention_v2 with a gradient on
    fp32 operands, on the CPU (plain K4 or K7 forward, plain K6 + K5 backward:
    the functions the card's fp32 kernels are held to) vs jax.grad of
    flash_attention_v5 / flash_attention_v2 in interpret mode (their custom
    VJP: stats forward, fp32 recompute, the Pallas backward, which casts every
    operand to fp32): 2e-5 abs, as test_bwd_ref_matches_pallas_bwd holds fp32.
    The forward matches the JAX forward to 2e-6."""
    h = 2
    (qn, kn, vn, gn), (q, k, v, g) = _cross(nq, nk, h, dh, "float32", seed=19 + dh + nk)
    jax_fn = {"flash_attention": flash_attention_v5, "flash_attention_v2": flash_attention_v2}[entry]

    def loss(a, b, c):
        return jnp.sum(jax_fn(a, b, c, h, block_q=blocks[0], block_k=blocks[1], interpret=True) * jnp.asarray(gn))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want_out = jax_fn(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, block_q=blocks[0], block_k=blocks[1],
                      interpret=True)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(FA.LAUNCHES)
    out = getattr(FA, entry)(*leaves, h)
    assert out.grad_fn is not None and out.dtype == torch.float32
    close(out, want_out, atol=2e-6)
    (out * g).sum().backward()
    assert FA.LAUNCHES == before  # CPU tensors: plain versions, no launch
    for leaf, wi in zip(leaves, want):
        assert leaf.grad.dtype == torch.float32
        close(leaf.grad, np.asarray(wi), atol=2e-5)


def test_no_grad_call_writes_no_stats_and_builds_no_graph():
    """Without a gradient the wrapper is K1's path: no autograd node."""
    (_, q), (_, k), (_, v) = _inputs(64, 2, 16, "bfloat16", seed=1)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        assert FA.flash_attention(*leaves, 2).grad_fn is None
    assert FA.flash_attention(q.detach(), k.detach(), v.detach(), 2).grad_fn is None


# -------------------------------------------------------------- GEGLU, GN
def test_geglu_grads_match_jax_vjp():
    """Autograd through the repaired wrapper (CPU: the plain forward; backward
    through the copy of _ref_impl) vs jax.grad through geglu_ff(interpret=True)
    and its _ref_impl VJP, fp32: 1e-5."""
    rng = np.random.default_rng(4)
    m, c, inner = 200, 64, 256
    x, wp, bp, wo, bo, g = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((m, c), 1.0), ((c, 2 * inner), 0.1), ((2 * inner,), 0.1), ((inner, c), 0.1), ((c,), 0.1), ((m, c), 1.0))]

    def loss(*args):
        return jnp.sum(jax_geglu_ff(*args, interpret=True) * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in (x, wp, bp, wo, bo)))
    leaves = [t(a).requires_grad_(True) for a in (x, wp.T.copy(), bp, wo.T.copy(), bo)]
    out = FF.geglu_ff(*leaves)
    assert out.grad_fn is not None and FF.LAUNCHES == 0
    (out * t(g)).sum().backward()
    wants = [want[0], want[1].T, want[2], want[3].T, want[4]]
    for leaf, wi in zip(leaves, wants):
        close(leaf.grad, np.asarray(wi), atol=1e-5, rtol=1e-5)


def test_groupnorm_grads_through_gn_sums_match_jax():
    """GroupNorm32 at a K3-eligible shape (h*w >= 2^14, >= 2^21 elements), its
    sums through the repaired wrapper, vs jax.grad of the JAX GroupNorm32 with
    its sums through _gn_sums (the Pallas kernel in interpret mode and its
    custom VJP), fp32: 1e-5 of each gradient's peak."""
    shape = (1, 128, 128, 128)  # NHWC
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jmod = JL.GroupNorm32(epsilon=1e-6)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :2, :2]))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.arange(p.size, dtype=p.dtype) / p.size, params)
    pallas_sums = functools.partial(JL._gn_sums, interpret=True)
    with mock.patch.object(JL, "_gn_pallas_eligible", lambda x: True), \
            mock.patch.object(JL, "_gn_sums", lambda x: pallas_sums(x)):
        def loss(p, xx):
            return jnp.sum(jmod.apply({"params": p}, xx) * jnp.asarray(g))

        wp, wx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = TL.GroupNorm32(128, eps=1e-6)
    tmod.load_state_dict(flax_tree_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    assert TL.gn_kernel_eligible(xt)
    calls = []
    real = TL.gn_sums
    with mock.patch.object(TL, "gn_sums", lambda a: calls.append(a.requires_grad) or real(a)):
        out = tmod(xt)
    assert calls == [True] and GN.LAUNCHES == 0
    (out * t(g).permute(0, 3, 1, 2)).sum().backward()
    grad_x = xt.grad.permute(0, 2, 3, 1)
    close(grad_x, wx, atol=1e-5 * float(np.abs(np.asarray(wx)).max()))
    close(tmod.weight.grad, wp["GroupNorm_0"]["scale"], atol=1e-5 * float(np.abs(wp["GroupNorm_0"]["scale"]).max()))
    close(tmod.bias.grad, wp["GroupNorm_0"]["bias"], atol=1e-5 * float(np.abs(wp["GroupNorm_0"]["bias"]).max()))


def test_gn_sums_backward_formula():
    """dx = ds1 + 2*x*ds2, cast to x's dtype (the JAX _gn_sums_bwd)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=gen).to(torch.bfloat16).requires_grad_(True)
    w1, w2 = torch.randn(2, 3, generator=gen), torch.randn(2, 3, generator=gen)
    s1, s2 = GN.gn_sums(x)
    (s1 * w1 + s2 * w2).sum().backward()
    want = (w1[:, :, None, None] + 2.0 * x.detach().float() * w2[:, :, None, None]).to(torch.bfloat16)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, want)
