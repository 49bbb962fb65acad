"""The third slice's kernels and attention entry points against the JAX package.

K8 (``flash_attention`` v1), K7 (``_flash_v2_stats``) and K9
(``_pallas_impl_wide``): each plain version against its Pallas kernel in
interpret mode, as ``tests/test_pallas_*.py`` run them; ``flash_attention_v2``'s
gradients against ``jax.grad`` through its custom VJP; the fp32 route of the
port's ``flash_attention`` (repair: it reached a bf16-only launch) against
``flash_attention_v5``. The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``); here a CPU tensor takes the plain version and
counts no launch.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vface_torch.ops as O
from _torch_port import close, t
from vface_tpu import ops as jax_ops
from vface_tpu.ops.pallas_attention import (
    _flash_v2_stats, flash_attention as jax_flash_v1, flash_attention_v2 as jax_flash_v2, flash_attention_v5,
)
from vface_tpu.ops.pallas_ff import _pallas_impl_wide
from vface_torch.ops import flash_attention as FA
from vface_torch.ops import geglu_ff as FF

BF16 = ml_dtypes.bfloat16


def _arrays(shapes, dtype, seed):
    """Seeded normal arrays: numpy in ``dtype`` and the same values as torch."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.normal(size=s).astype(np.float32)
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


# ------------------------------------------------------------------------ K8
V1_CASES = {
    # JAX's own test shape (tests/test_pallas_attention.py), fp32, blocks 128
    "jax_shape": ((2, 512, 128), (2, 512, 128), 4, (128, 128), "float32"),
    # JAX's ragged shape: N = 100 tiles with no block, so both go to multi_head_attention
    "ragged": ((1, 100, 32), (1, 100, 32), 2, (64, 64), "float32"),
    "nq_ne_nk": ((2, 256, 80), (2, 128, 80), 2, (128, 64), "float32"),
    "bf16": ((2, 256, 128), (2, 256, 128), 4, (128, 128), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_v1_matches_pallas_flash_attention(case):
    """fp32: round-off in another summation order, 2e-5 (the Pallas backward's
    tolerance in test_pallas_attention.py; the kernel itself is held to its
    plain version on the card). bf16 inputs: fp32 math and one rounding of the
    output on both sides, so 2 bf16 ulps of the output's peak."""
    qs, ks, h, blocks, dtype = V1_CASES[case]
    (qn, q), (kn, k), (vn, v) = _arrays((qs, ks, ks), dtype, seed=len(case))
    want = jax_flash_v1(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, *blocks, interpret=True)
    before = dict(FA.LAUNCHES)
    got = O.flash_attention_v1(q, k, v, h, *blocks)
    assert got.dtype == q.dtype and FA.LAUNCHES == before
    close(got, np.asarray(want, np.float32), atol=_ulps(want, 2) if dtype == "bfloat16" else 2e-5)
    if case == "ragged":  # the JAX routing: the einsum path, exactly
        assert torch.equal(got, O.multi_head_attention(q, k, v, h, dtype=q.dtype))


# ------------------------------------------------------------------------ K7
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_stats_ref_matches_pallas(dtype):
    """out: 2e-5 at fp32, 2 bf16 ulps at bf16 (fp32 math, one rounding); m is
    the exact row max of the same fp32 scores and l its sum in another order:
    1e-5 relative."""
    h, n, dh = 2, 256, 40
    (qn, q), (kn, k), (vn, v) = _arrays([(2, n, h * dh)] * 3, dtype, seed=11)
    want, wm, wl = _flash_v2_stats(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, 128, 128, True)
    got, m, l = FA.flash_attention_v2_stats(q, k, v, h, block_k=128)
    assert got.dtype == q.dtype and m.shape == (2 * h, n) == l.shape
    close(got, np.asarray(want, np.float32), atol=2e-5 if dtype == "float32" else _ulps(want, 2))
    close(m, wm, atol=0.0, rtol=1e-5)
    close(l, wl, atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_gradients_match_jax_grad(dtype):
    """flash_attention_v2 on the CPU (plain K7 forward; plain K6, D and K5
    backward) vs jax.grad through flash_attention_v2 in interpret mode (its
    custom VJP: _flash_v2_stats, then flash_attention_bwd), n = 256, dh = 40:
    fp32 2e-5, bf16 2 ulps of each gradient's peak. The forward matches too."""
    h, n, dh = 2, 256, 40
    (qn, q), (kn, k), (vn, v), (gn, g) = _arrays([(2, n, h * dh)] * 4, dtype, seed=12)
    jg = jnp.asarray(gn).astype(jnp.float32)

    def loss(a, b, c):
        return jnp.sum(jax_flash_v2(a, b, c, h, 128, 128, interpret=True).astype(jnp.float32) * jg)

    args = [jnp.asarray(a) for a in (qn, kn, vn)]
    want_out = jax_flash_v2(*args, h, 128, 128, interpret=True)
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = O.flash_attention_v2(*leaves, h, 128, 128)
    assert out.grad_fn is not None
    tol = (lambda w: 2e-5) if dtype == "float32" else (lambda w: _ulps(w, 2))
    close(out, np.asarray(want_out, np.float32), atol=tol(want_out))
    (out.float() * g.float()).sum().backward()
    for leaf, wi in zip(leaves, want):
        close(leaf.grad, np.asarray(wi, np.float32), atol=tol(wi))


def test_v2_without_gradient_is_k6s_function():
    """No gradient: K6's function over v2's key blocks (plain on the CPU), as
    JAX's _flash_v2_impl computes it; the ragged N goes to the einsum path."""
    h = 2
    (qn, q), (kn, k), (vn, v) = _arrays([(1, 256, 80)] * 3, "float32", seed=13)
    want = jax_flash_v2(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, 128, 128, interpret=True)
    with torch.no_grad():
        close(O.flash_attention_v2(q, k, v, h, 128, 128), want, atol=2e-5)
    r = q[:, :100]
    assert torch.equal(O.flash_attention_v2(r, r, r, h, 64, 64), O.multi_head_attention(r, r, r, h))


# ------------------------------------------------------------------------ K9
def test_wide_ref_matches_pallas_wide():
    """Plain K9 vs _ff_kernel_wide (interpret) at JAX's test shape (160, 1024),
    I = 4096, bf16 at that test's scales. The four rounding points match; the
    TPU kernel's erf is the Abramowitz-Stegun form and its output product sums
    over 512-wide inner blocks, ours in one fp32 product, so a bf16
    intermediate may move by one ulp: K2's CPU tolerance, atol 2e-2."""
    rng = np.random.default_rng(5)
    m, c = 160, 1024
    raw = [rng.normal(size=(m, c)) * 0.1, rng.normal(size=(c, 8 * c)) * 0.02, rng.normal(size=(8 * c,)) * 0.01,
           rng.normal(size=(4 * c, c)) * 0.02, rng.normal(size=(c,)) * 0.01]
    bf = [np.asarray(a, np.float32).astype(BF16) for a in raw]
    x, wp, bp, wo, bo = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in bf]
    want = _pallas_impl_wide(*[jnp.asarray(a) for a in bf], True)
    got = O.geglu_ff_wide(x, wp.t().contiguous(), bp, wo.t().contiguous(), bo)
    assert got.dtype == torch.bfloat16 and FF.WIDE_LAUNCHES == 0
    close(got, np.asarray(want, np.float32), atol=2e-2)
    assert torch.equal(got, FF.geglu_ff_ref(x, wp.t().contiguous(), bp, wo.t().contiguous(), bo))


# ---------------------------------------------------------------- repair 0b
def test_fp32_flash_attention_matches_flash_v5():
    """The port's flash_attention on fp32 operands (no gradient) vs JAX's
    flash_attention_v5 in interpret mode, where P.astype(v.dtype) is a no-op:
    v2's function, 2e-5. On the card this is K8's launch."""
    h, n, dh = 2, 256, 40
    (qn, q), (kn, k), (vn, v) = _arrays([(2, n, h * dh)] * 3, "float32", seed=14)
    want = flash_attention_v5(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, 128, 64, interpret=True)
    with torch.no_grad():
        got = FA.flash_attention(q, k, v, h)
    close(got, want, atol=2e-5)
    close(FA.flash_attention_v1_ref(q, k, v, h), want, atol=2e-5)


def test_ops_exports_cover_the_jax_package():
    """Every name vface_tpu.ops exports has its counterpart here; JAX's
    flash_attention (the submodule's name in the port) as flash_attention_v1."""
    want = {"flash_attention_v1" if name == "flash_attention" else name for name in jax_ops.__all__}
    assert want <= set(O.__all__)
    assert all(callable(getattr(O, name)) for name in O.__all__)
    assert O.flash_attention_v1 is FA.flash_attention_v1 and O.geglu_ff_wide is FF.geglu_ff_wide
