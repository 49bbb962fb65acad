"""The fourth slice's kernels (K10-K13) and the kernel benches against the JAX package.

K10-K12 (``vface_torch/ops/_archive_attention.py``): the port's
``flash_attention_v3``, ``_v4`` and ``_v6`` on the CPU (their plain versions)
against the JAX package's, run in interpret mode as
``tests/test_pallas_attention.py`` runs them, at that test's shapes.

K13 (``geglu_ff_split``): its plain version (K2's) against
``vface_tpu/ops/pallas_ff.py::_pallas_impl`` in interpret mode at each row
tile the port builds. ``_pallas_impl`` stands for ``scripts/bench_ff_tile.py::
_pallas_split``, the TPU kernel K13 replaces, because their kernel bodies
(``_ff_kernel`` and ``_ff_kernel_split``) are the same line for line and both
take ``tm`` as the row tile; the script itself is not imported (importing it
points JAX's compilation cache into the repo).

The benches (``vface_torch/bench``): every variant callable runs on CPU
tensors at a small shape and agrees with the einsum path. The CUDA kernels
run only on the card (``tests/test_torch_cuda.py``).
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import close, t
from vface_tpu.ops import _archive_attention as JAA
from vface_tpu.ops.attention import multi_head_attention as jax_mha
from vface_tpu.ops.pallas_ff import _pallas_impl
from vface_torch.bench import attention as bench_attention
from vface_torch.bench import attn_bwd_wide as bench_bwd
from vface_torch.bench import attn_f32 as bench_f32
from vface_torch.bench import attn_v56 as bench_v56
from vface_torch.bench import ff_tile as bench_ff
from vface_torch.ops import _archive_attention as AA
from vface_torch.ops import flash_attention as FA
from vface_torch.ops import geglu_ff as FF
from vface_torch.ops.attention import multi_head_attention

BF16 = ml_dtypes.bfloat16
VARIANTS = ("flash_attention_v3", "flash_attention_v4", "flash_attention_v6")


def _ulps(want, count=2):
    """``count`` bf16 ulps at the peak of |want|."""
    peak = float(np.abs(np.asarray(want, np.float32)).max())
    return count * 2.0 ** (math.floor(math.log2(peak)) - 7)


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.normal(size=shape).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(BF16)
            out.append((a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)))
        else:
            out.append((a, t(a)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", VARIANTS)
def test_archive_variant_matches_pallas(name, dtype):
    """b 2, N 256, h 4, dh 40, blocks (128, 64), as tests/test_pallas_attention.py.
    fp32: another summation order only, 2e-5. bf16: both round the same fp32
    values (v3/v4: the output once; v6: P over the same 64-key blocks, then the
    output), so 2 bf16 ulps of the output's peak. No launch on the CPU."""
    h = 4
    (qn, q), (kn, k), (vn, v) = _qkv((2, 256, h * 40), dtype, seed=VARIANTS.index(name) + 3)
    want = getattr(JAA, name)(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, block_q=128, block_k=64,
                              interpret=True)
    before = dict(FA.LAUNCHES)
    got = getattr(AA, name)(q, k, v, h, block_q=128, block_k=64)
    assert got.dtype == q.dtype and FA.LAUNCHES == before
    close(got, np.asarray(want, np.float32), atol=2e-5 if dtype == "float32" else _ulps(want))


@pytest.mark.parametrize("name", VARIANTS)
def test_archive_variant_routes_ragged_shapes_to_einsum(name):
    """N = 100 tiles with no 64 block: JAX's XLA path, multi_head_attention,
    exactly the port's (and within 2e-6 of JAX's own)."""
    h = 2
    (qn, q), (kn, k), (vn, v) = _qkv((1, 100, h * 16), "float32", seed=9)
    got = getattr(AA, name)(q, k, v, h, block_q=64, block_k=64)
    assert torch.equal(got, multi_head_attention(q, k, v, h, dtype=q.dtype))
    close(got, jax_mha(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h), atol=2e-6)


def test_v6_at_fp32_is_v2s_function_over_the_callers_blocks():
    """fp32 operands: v6's P.astype is a no-op, so it is K8's function; the
    plain version walks the caller's key blocks (here 128, not K1's 64)."""
    h = 2
    (qn, q), (kn, k), (vn, v) = _qkv((1, 256, h * 80), "float32", seed=10)
    want = JAA.flash_attention_v6(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), h, 128, 128, interpret=True)
    got = AA.flash_attention_v6(q, k, v, h, 128, 128)
    close(got, want, atol=2e-5)
    assert torch.equal(got, FA.flash_attention_v1_ref(q, k, v, h, block_k=128))


@pytest.mark.parametrize("c", [320, 640])
def test_geglu_ff_split_matches_pallas_at_every_built_tile(c):
    """K13's plain version (K2's) against _pallas_impl in interpret mode at each
    row tile in SPLIT_TILES[C], M = 72 (ragged for every tile), the bench's
    scales: the same four rounding points; the TPU kernel's erf is the
    Abramowitz-Stegun form, which may move one bf16 intermediate by an ulp,
    far below the output's: 2 bf16 ulps at the output's peak."""
    rng = np.random.default_rng(c)
    m, inner = 72, 4 * c
    raw = [rng.normal(size=(m, c)), rng.normal(size=(c, 2 * inner)) * c**-0.5, rng.normal(size=(2 * inner,)) * 0.1,
           rng.normal(size=(inner, c)) * inner**-0.5, rng.normal(size=(c,)) * 0.1]
    bf = [np.asarray(a, np.float32).astype(BF16) for a in raw]
    x, wp, bp, wo, bo = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in bf]
    port = (x, wp.t().contiguous(), bp, wo.t().contiguous(), bo)
    assert FF.SPLIT_TILES[c]
    for tm in FF.SPLIT_TILES[c]:
        want = _pallas_impl(*[jnp.asarray(a) for a in bf], True, tm)
        got = FF.geglu_ff_split(*port, tm)
        assert got.dtype == torch.bfloat16 and FF.SPLIT_LAUNCHES == 0
        close(got, np.asarray(want, np.float32), atol=_ulps(want))
        assert torch.equal(got, FF.geglu_ff_ref(*port))
    with pytest.raises(ValueError, match="no kernel"):
        FF.geglu_ff_split(*port, 32)  # a tile built at neither width


@pytest.mark.parametrize("c", [320, 640])
def test_geglu_ff_split_fp32_matches_pallas(c):
    """K13 on fp32 operands (K2's fp32 two-kernel form on the card) against
    _pallas_impl in interpret mode at fp32, at its one tile (128 rows),
    M = 200 (ragged for the 128-row tile): every rounding
    point is a no-op at fp32, the TPU kernel's erf is the Abramowitz-Stegun
    form: within 1e-5 of the output's peak. The bf16-only tile at C = 320
    raises for fp32 operands."""
    rng = np.random.default_rng(c + 1)
    m, inner = 200, 4 * c
    raw = [np.asarray(a, np.float32) for a in (
        rng.normal(size=(m, c)), rng.normal(size=(c, 2 * inner)) * c**-0.5, rng.normal(size=(2 * inner,)) * 0.1,
        rng.normal(size=(inner, c)) * inner**-0.5, rng.normal(size=(c,)) * 0.1)]
    x, wp, bp, wo, bo = [t(a) for a in raw]
    port = (x, wp.t().contiguous(), bp, wo.t().contiguous(), bo)
    want = np.asarray(_pallas_impl(*[jnp.asarray(a) for a in raw], True, 128), np.float32)
    got = FF.geglu_ff_split(*port, 128)
    assert got.dtype == torch.float32 and FF.SPLIT_F32_LAUNCHES == 0
    close(got, want, atol=1e-5 * float(np.abs(want).max()))
    if c == 320:
        with pytest.raises(ValueError, match="no kernel"):
            FF.geglu_ff_split(*port, 64)


def test_attention_bench_variants_agree_on_the_cpu():
    """Every port counterpart in the attention benches runs (plain versions on
    the CPU) at a small shape and agrees with the einsum path within the bf16
    tolerance of tests/test_pallas_attention.py (0.04); the TPU library
    kernels are named as having none."""
    b, n = 2, 64
    q, k, v = (bench_attention.randn((b, n, 320), seed=s, device="cpu") for s in range(3))
    want = multi_head_attention(q, k, v, 8, dtype=q.dtype).float()
    for table in (bench_attention.variants(b, n), bench_v56.variants(b, n)):
        for name, fn in table.items():
            if isinstance(fn, str):
                assert name in ("jax_fa", "splash") and "no counterpart" in fn
                continue
            got = fn(q, k, v)
            assert got.shape == q.shape and got.dtype == torch.bfloat16, name
            close(got, want, atol=0.04)


def test_attn_f32_bench_entries_agree_on_the_cpu():
    """The fp32 bench's entries (K8, K4, K6, K7; plain versions on the CPU)
    compute one attention: at a small fp32 shape of each of its head widths
    each output is within 1e-5 of the einsum path's (SDPA's too), and none launches."""
    assert {c // bench_f32.H for _, _, c in bench_f32.CASES} == {40, 80}
    before = dict(FA.LAUNCHES)
    for c in (320, 640):
        q, k, v = (bench_f32.randn((2, 64, c), seed=s, device="cpu", dtype=torch.float32) for s in range(3))
        want = multi_head_attention(q, k, v, bench_f32.H, dtype=torch.float32)
        for name, fn in bench_f32.ENTRIES.items():
            got = fn(q, k, v, bench_f32.H)
            got = got[0] if isinstance(got, tuple) else got
            assert got.shape == q.shape and got.dtype == torch.float32, name
            close(got, want, atol=1e-5)
    assert FA.LAUNCHES == before


def test_ff_tile_bench_operands_and_cases():
    """The sweep's shapes are the JAX script's, and its operands feed K13 and the
    unfused route, which agree within 2 ulps at a small M on the CPU."""
    assert bench_ff.CASES == ((320, 24 * 4096), (640, 24 * 1024))
    x, wp, bp, wo, bo = bench_ff.operands(320, 64, device="cpu")
    assert wp.shape == (2560, 320) and wo.shape == (320, 1280) and not bp.any()
    got = FF.geglu_ff_split(x, wp, bp, wo, bo, FF.SPLIT_TILES[320][0])
    want = FF.geglu_ff_unfused(x, wp, bp, wo, bo)
    close(got, want.float().numpy(), atol=_ulps(want.float().numpy()))


def test_attn_bwd_wide_bench_entries_agree_on_the_cpu():
    """The K5 bench's shapes are ds4's dh 160 (split into kernels, beside
    SDPA's backward) and ds1/ds2's dh 40/80; on the CPU its K5 entry (the plain
    version) and its SDPA-backward entry give the same fp32 gradients, within
    1e-5 of each one's peak, at a ragged N of each width, and none launches."""
    assert {c // bench_bwd.H for _, _, c in bench_bwd.WIDE} == {160}
    assert {c // bench_bwd.H for _, _, c in bench_bwd.NARROW} == {40, 80}
    before = dict(FA.LAUNCHES)
    for n, c in ((65, 320), (65, 1280)):
        entries = bench_bwd._entries(*bench_bwd._inputs(1, n, c, torch.float32, "cpu"), split=True)
        assert set(entries) == {"K5", "SDPA backward"}
        b, h = 1, bench_bwd.H
        merge = lambda t: t.transpose(1, 2).reshape(b, n, c)
        for got, want in zip(entries["K5"](), (merge(t) for t in entries["SDPA backward"]())):
            assert got.shape == (b, n, c) and got.dtype == torch.float32
            close(got, want, atol=1e-5 * float(want.abs().max()))
    assert FA.LAUNCHES == before
