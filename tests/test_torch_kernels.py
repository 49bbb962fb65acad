"""The port's three kernels: each plain PyTorch version against the Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as ``tests/test_pallas_*.py``
run them, in the kernels' working dtype (bf16) where the rounding points are the
point. The CUDA and Triton kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``); here the wrappers must take
the plain version for a CPU tensor without counting a launch.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import close, t
from vface_tpu.models.layers import _gn_sums_pallas
from vface_tpu.ops.attention import multi_head_attention as jax_mha
from vface_tpu.ops.pallas_attention import flash_attention_v5
from vface_tpu.ops.pallas_ff import _gelu_erf, geglu_ff as jax_geglu_ff
from vface_torch.ops import flash_attention as FA
from vface_torch.ops import geglu_ff as FF
from vface_torch.ops import gn_sums as GN

BF16 = ml_dtypes.bfloat16


def _bf16(a):
    """numpy bf16 values, and the same values as float32 torch bf16."""
    a = np.asarray(a, np.float32).astype(BF16)
    return a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dh", [40, 80])
def test_flash_ref_matches_pallas_v5(dh):
    """Blockwise plain version vs _flash_kernel_v5 (interpret), bf16, N = 256.

    Both round P to bf16 against the running max of the same 64-key blocks;
    what remains is fp32 summation order, which can move a bf16 rounding of
    the output by one ulp (2^-8 relative): atol 1e-2 at |out| < 1.
    """
    rng = np.random.default_rng(dh)
    b, n, h = 2, 256, 2
    arrs = [_bf16(rng.normal(size=(b, n, h * dh))) for _ in range(3)]
    want = flash_attention_v5(*[jnp.asarray(a) for a, _ in arrs], h, block_q=128, block_k=64,
                              interpret=True)
    got = FA.flash_attention_ref(*[x for _, x in arrs], h)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), atol=1e-2)


def test_flash_ref_matches_pallas_v5_cross_attention():
    """Nq != Nk (128 queries over 256 keys, dh 40, bf16): the plain version of
    K1, which the kernel takes at any Nq and Nk, vs _flash_kernel_v5
    (interpret) over the same 64-key blocks; atol 1e-2 as for Nq == Nk."""
    rng = np.random.default_rng(7)
    b, h, dh = 2, 2, 40
    q = _bf16(rng.normal(size=(b, 128, h * dh)))
    kv = [_bf16(rng.normal(size=(b, 256, h * dh))) for _ in range(2)]
    want = flash_attention_v5(*[jnp.asarray(a) for a, _ in (q, *kv)], h, block_q=128, block_k=64,
                              interpret=True)
    got = FA.flash_attention_ref(*[x for _, x in (q, *kv)], h)
    assert got.shape == (b, 128, h * dh) and got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), atol=1e-2)


@pytest.mark.parametrize("n", [256, 300])
def test_flash_ref_fp32_matches_softmax_attention(n):
    """In fp32 the online softmax is exact algebra: it equals the full softmax
    (JAX multi_head_attention) to fp32 round-off, ragged last block included."""
    rng = np.random.default_rng(n)
    q, k, v = [rng.normal(size=(2, n, 4 * 16)).astype(np.float32) for _ in range(3)]
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    close(FA.flash_attention_ref(t(q), t(k), t(v), 4), want, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_ref_matches_pallas(dtype):
    """Plain GEGLU vs _ff_kernel (interpret) at C = 64, I = 256.

    fp32: round-off only (atol 2e-5). bf16: the four rounding points match;
    the TPU kernel's erf is the Abramowitz-Stegun form and ours is exact
    erf, and summation order differs, so a bf16 intermediate may move by one
    ulp: atol 2e-2 at |out| ~ 1 (the tolerance tests/test_pallas_ff.py uses).
    """
    rng = np.random.default_rng(3)
    m, c, inner = 300, 64, 256
    raw = [rng.normal(size=(m, c)), rng.normal(size=(c, 2 * inner)) * 0.1,
           rng.normal(size=(2 * inner,)) * 0.1, rng.normal(size=(inner, c)) * 0.1,
           rng.normal(size=(c,)) * 0.1]
    if dtype == "bfloat16":
        pairs = [_bf16(a) for a in raw]
        jx = [jnp.asarray(a) for a, _ in pairs]
        x, wp, bp, wo, bo = [p for _, p in pairs]
        atol = 2e-2
    else:
        jx = [jnp.asarray(np.asarray(a, np.float32)) for a in raw]
        x, wp, bp, wo, bo = [t(np.asarray(a, np.float32)) for a in raw]
        atol = 2e-5
    want = jax_geglu_ff(*jx, interpret=True)
    got = FF.geglu_ff_ref(x, wp.t().contiguous(), bp, wo.t().contiguous(), bo)
    close(got, np.asarray(want, np.float32), atol=atol)


def test_erff_gelu_matches_abramowitz_stegun_in_bf16():
    """The CUDA kernel uses exact erff where the Pallas kernel uses the A-S
    polynomial (|error| <= 1.5e-7). Over every finite bf16 gate value in
    [-8, 8] with |gate| >= 1e-30 (below that g is subnormal, and JAX on the
    CPU flushes subnormals to zero), bf16(g) is identical for |gate| < 3; below -3, where g is under 3e-3, the
    polynomial's absolute error can move g by at most 2e-5, for under 1% of
    the values."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    gate = bits.view(BF16).astype(np.float32)
    gate = gate[np.isfinite(gate) & (np.abs(gate) <= 8.0)]
    exact = FF.gelu_erf(torch.from_numpy(gate)).to(torch.bfloat16).float().numpy()
    approx = np.asarray(_gelu_erf(jnp.asarray(gate)), np.float32).astype(BF16).astype(np.float32)
    diff = np.abs(exact - approx)
    normal = np.abs(gate) >= 1e-30
    assert np.all(diff[normal & (np.abs(gate) < 3.0)] == 0.0)
    assert diff.max() <= 2e-5
    assert np.mean(diff[normal] > 0) < 0.01


@pytest.mark.parametrize("shape,dtype", [((2, 16, 16, 128), "bfloat16"), ((2, 32, 16, 64), "float32")])
def test_gn_sums_ref_matches_pallas(shape, dtype):
    """Plain (sum, sum of squares) vs _gn_sums_kernel (interpret). Both add bf16
    values in fp32, in another order: rtol 1e-5 of the row sums."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        xj, xt = _bf16(x)
        xj = jnp.asarray(xj)
    else:
        xj, xt = jnp.asarray(x), t(x)
    w1, w2 = _gn_sums_pallas(xj, interpret=True)
    s1, s2 = GN.gn_sums(xt.permute(0, 3, 1, 2).contiguous())  # the port's NCHW
    scale = np.abs(np.asarray(xj, np.float32)).sum(axis=(1, 2))
    close(s1 / torch.from_numpy(scale), np.asarray(w1) / scale, atol=1e-5)
    close(s2, w2, atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["flash_attention", "geglu_ff", "gn_sums"])
def test_cpu_tensor_takes_plain_version_without_a_launch(kernel):
    mod = {"flash_attention": FA, "geglu_ff": FF, "gn_sums": GN}[kernel]
    count = lambda: mod.LAUNCHES[kernel] if kernel == "flash_attention" else mod.LAUNCHES
    before = count()
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    if kernel == "flash_attention":
        q, k, v = r(1, 64, 32), r(1, 64, 32), r(1, 64, 32)
        out, ref = FA.flash_attention(q, k, v, 2), FA.flash_attention_ref(q, k, v, 2)
    elif kernel == "geglu_ff":
        args = (r(1, 8, 64), r(512, 64), r(512), r(64, 256), r(64))
        out, ref = FF.geglu_ff(*args), FF.geglu_ff_ref(*args)
    else:
        x = r(2, 4, 8, 8)
        out, ref = GN.gn_sums(x)[1], GN.gn_sums_ref(x)[1]
    assert torch.equal(out, ref)
    assert count() == before


def test_nvcc_build_is_deferred_and_content_addressed():
    """Importing the ops compiles nothing; the library name hashes source and flags."""
    from vface_torch.ops import _native

    assert _native._libs == {}
    paths = {name: _native.lib_path(name) for name in _native.SOURCES}
    assert all(p.parent == _native.BUILD_DIR and p.suffix == ".so" for p in paths.values())
    assert len(set(paths.values())) == len(_native.SOURCES)


# The forward kernel's query tile at every batch of the main paths (8 heads),
# as k1_tiles on an H100 (132 SMs) measured it: 128 rows where 192-row tiles
# give fewer than two CTAs per SM, else 192; K6 at dh 80 is built at 128 only.
@pytest.mark.parametrize("b,n,dh,k1,k6", [
    (1, 4096, 40, 2, 2), (2, 4096, 40, 3, 3), (4, 4096, 40, 3, 3), (6, 4096, 40, 3, 3), (12, 4096, 40, 3, 3),
    (1, 1024, 80, 2, 2), (2, 1024, 80, 2, 2), (4, 1024, 80, 2, 2), (6, 1024, 80, 3, 2), (12, 1024, 80, 3, 2)])
def test_forward_query_tile_rule(monkeypatch, b, n, dh, k1, k6):
    monkeypatch.setattr(FA, "_sm_count", lambda device: 132)
    assert FA.k1_consumers(b * 8, n, "cuda", False, dh) == k1
    assert FA.k1_consumers(b * 8, n, "cuda", True, dh) == k6
    assert FA.built_consumers(True, dh) == ((2,) if dh == 80 else (2, 3)) and FA.built_consumers(False, dh) == (2, 3)


# The tf32 forward's route at dh 160 (8 heads, an H100's 132 SMs): clusters of
# two CTAs over dh's halves where their grid fits in one wave (a train step's
# b = 1 at 576 and 1024 tokens: 80 and 128 CTAs), else one CTA per 128 rows
# (the 768^2 fp32 eval's batch of 2: 160 CTAs as clusters); never below dh 160.
@pytest.mark.parametrize("b,n,dh,cluster", [
    (1, 1024, 160, True), (1, 576, 160, True), (2, 576, 160, False), (12, 576, 160, False), (2, 1024, 160, False),
    (1, 1024, 80, False), (1, 4096, 40, False), (1, 1056, 160, False)])
def test_tf32_forward_cluster_rule(monkeypatch, b, n, dh, cluster):
    monkeypatch.setattr(FA, "_sm_count", lambda device: 132)
    assert FA.f32_cluster(b * 8, n, dh, "cuda") == cluster


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties away
    from zero, the 13 low mantissa bits cleared (wgmma reads only the top 19)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_attention(q, k, v, heads: int, terms: frozenset) -> torch.Tensor:
    """The tf32 kernel's arithmetic in plain form: every operand split into
    hi = tf32(x), lo = tf32(x - hi); S and P.V each summed over the product
    terms in ``terms`` ("s_hh", "s_lh", "s_hl", "pv_hh", "pv_lh", "pv_hl": hi.hi,
    lo.hi, hi.lo), exactly (float64); the softmax in float64 over all keys."""
    b, nq, d = q.shape
    dh = d // heads
    heads_of = lambda x: x.reshape(b, -1, heads, dh).transpose(1, 2)
    split = lambda x: (tf32(x), tf32(x - tf32(x)))
    (qh, ql), (kh, kl), (vh, vl) = (tuple(heads_of(p).double() for p in split(x)) for x in (q, k, v))
    pairs = {"hh": lambda a, b: (a[0], b[0]), "lh": lambda a, b: (a[1], b[0]), "hl": lambda a, b: (a[0], b[1])}
    s = sum(x @ y.transpose(-1, -2) for t, f in pairs.items() if f"s_{t}" in terms for x, y in [f((qh, ql), (kh, kl))])
    p = torch.exp(s * dh**-0.5 - (s * dh**-0.5).amax(-1, keepdim=True)).float()
    ph, pl = (x.double() for x in split(p))
    o = sum(x @ y for t, f in pairs.items() if f"pv_{t}" in terms for x, y in [f((ph, pl), (vh, vl))])
    return (o / p.double().sum(-1, keepdim=True)).float().transpose(1, 2).reshape(b, nq, d)


ALL_TERMS = frozenset({"s_hh", "s_lh", "s_hl", "pv_hh", "pv_lh", "pv_hl"})


@pytest.mark.parametrize("terms,meets", [
    (ALL_TERMS, True), (frozenset({"s_hh", "pv_hh"}), False),
    (ALL_TERMS - {"s_lh"}, False), (ALL_TERMS - {"pv_lh"}, False)])
@pytest.mark.parametrize("nq,nk,heads,dh", [(300, 300, 2, 40), (130, 70, 3, 16), (257, 1000, 2, 80), (64, 200, 4, 32)])
def test_tf32_terms_against_the_card_limit(nq, nk, heads, dh, terms, meets):
    """Calibration of the fp32 card tests' limit, 1e-5 of the output's peak
    against K8's plain version, at their fp32 shapes: S and P.V as three tf32
    terms each (the tf32 kernel's split) meet it; one term each (plain tf32),
    or three with Q_lo.K_hi^T or P_lo.V_hi dropped, miss it. So the card tests
    tell a dropped lo term from the kernel's own round-off."""
    rng = np.random.default_rng(nq + nk + dh)
    q = torch.from_numpy(rng.normal(size=(2, nq, heads * dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, nk, heads * dh)).astype(np.float32)) for _ in range(2))
    want = FA.flash_attention_v1_ref(q, k, v, heads)
    err = (_tf32_attention(q, k, v, heads, terms) - want).abs().max() / want.abs().max()
    assert (err <= 1e-5) == meets, float(err)


def test_tf32_rounding_matches_its_definition():
    """tf32: the nearest value with 10 stored mantissa bits, ties away from zero."""
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-11 + 2**-20, -(1.0 + 3 * 2**-11), 3.0 + 2**-12, 0.0])
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-9), 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tf32(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - hi).abs() <= r.abs() * 2**-11).all())


def _tf32_product(name: str, a: torch.Tensor, b: torch.Tensor, terms: frozenset) -> torch.Tensor:
    """a @ b (fp32 operands) as the tf32 terms of ``terms`` named ``name``_hh, _lh
    and _hl (hi.hi, lo.hi, hi.lo of the hi + lo splits), each exact (float64)."""
    (ah, al), (bh, bl) = ((tf32(x), tf32(x - tf32(x))) for x in (a, b))
    pairs = {"hh": (ah, bh), "lh": (al, bh), "hl": (ah, bl)}
    return sum(x.double() @ y.double() for term, (x, y) in pairs.items() if f"{name}_{term}" in terms)


def _tf32_bwd(q, k, v, do, m, l, dd, heads: int, terms: frozenset):
    """K5's fp32 kernels' arithmetic in plain form: S = Q.K^T and dP = dO.V^T,
    then dQ = scale * dS.K, dK = scale * dS^T.Q and dV = P^T.dO, each product
    as the tf32 terms in ``terms`` ("s", "dp", "dq", "dk", "dv"), exactly; P and
    dS from those S and dP in float64, rounded to fp32 as the kernels hold them."""
    b, nq, d = q.shape
    dh = d // heads
    scale = dh**-0.5
    split = lambda x: x.reshape(b, -1, heads, dh).transpose(1, 2)
    stat = lambda x: x.reshape(b, heads, nq, 1).double()
    qh, kh, vh, doh = (split(x) for x in (q, k, v, do))
    s = _tf32_product("s", qh, kh.transpose(-1, -2), terms)
    dp = _tf32_product("dp", doh, vh.transpose(-1, -2), terms)
    p = (torch.exp(s * scale - stat(m)) / stat(l)).float()
    ds = (p.double() * (dp - stat(dd))).float()
    merge = lambda x: x.float().transpose(1, 2).reshape(b, -1, d)
    return (merge(_tf32_product("dq", ds, kh, terms) * scale),
            merge(_tf32_product("dk", ds.transpose(-1, -2), qh, terms) * scale),
            merge(_tf32_product("dv", p.transpose(-1, -2), doh, terms)))


BWD_TERMS = frozenset(f"{p}_{t}" for p in ("s", "dp", "dq", "dk", "dv") for t in ("hh", "lh", "hl"))


@pytest.mark.parametrize("terms,meets", [
    (BWD_TERMS, True), (frozenset(f"{p}_hh" for p in ("s", "dp", "dq", "dk", "dv")), False),
    (BWD_TERMS - {"s_lh"}, False), (BWD_TERMS - {"dp_lh"}, False), (BWD_TERMS - {"dq_lh"}, False),
    (BWD_TERMS - {"dk_lh"}, False), (BWD_TERMS - {"dv_lh"}, False)])
@pytest.mark.parametrize("nq,nk,heads,dh", [(300, 130, 2, 40), (130, 300, 3, 16), (257, 1000, 2, 80), (64, 200, 4, 32)])
def test_tf32_terms_of_the_backward_against_the_card_limit(nq, nk, heads, dh, terms, meets):
    """Calibration of the fp32 backward's card limit, each gradient within 1e-5
    of its peak against K5's plain version (the same m, l and D), at the card
    tests' fp32 shapes: the five products as three tf32 terms each (the
    kernels' split) meet it; one term each (plain tf32), or three with any one
    product's lo.hi term dropped, miss it. So the card tests tell a dropped lo
    term from the kernels' own round-off."""
    rng = np.random.default_rng(nq + nk + dh)
    q, do = (torch.from_numpy(rng.normal(size=(2, nq, heads * dh)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(2, nk, heads * dh)).astype(np.float32)) for _ in range(2))
    _, m, l = FA.flash_attention_stats_ref(q, k, v, heads)
    dd = FA.rowsum_do_o(do, FA.flash_attention_fp32_ref(q, k, v, heads), heads)
    want = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, heads)
    got = _tf32_bwd(q, k, v, do, m, l, dd, heads, terms)
    err = max(float((gi - wi).abs().max() / wi.abs().max()) for gi, wi in zip(got, want))
    assert (err <= 1e-5) == meets, err


def _tf32_geglu(x, wp, bp, wo, bo, terms: frozenset) -> torch.Tensor:
    """The fp32 GEGLU kernels' arithmetic in plain form: GEMM 1 (x against Wa
    and Wg) and GEMM 2 (h against Wo) as the tf32 terms in ``terms`` ("p",
    "o"), exactly; h = (a + ba) * gelu_erf(gate + bg) rounded to fp32, as GEMM
    1 stores it."""
    inner = wp.shape[0] // 2
    a = _tf32_product("p", x, wp[:inner].t(), terms) + bp[:inner].double()
    gate = _tf32_product("p", x, wp[inner:].t(), terms) + bp[inner:].double()
    h = (a * FF.gelu_erf(gate)).float()
    return (_tf32_product("o", h, wo.t(), terms) + bo.double()).float()


FF_TERMS = frozenset(f"{p}_{t}" for p in ("p", "o") for t in ("hh", "lh", "hl"))


@pytest.mark.parametrize("terms,meets", [
    (FF_TERMS, True), (frozenset({"p_hh", "o_hh"}), False), (FF_TERMS - {"p_lh"}, False),
    (FF_TERMS - {"o_lh"}, False), (FF_TERMS - {"p_hl"}, False)])
@pytest.mark.parametrize("m,c", [(300, 64), (257, 320), (100, 640), (17, 1280)])
def test_tf32_terms_of_the_feed_forward_against_the_card_limit(m, c, terms, meets):
    """Calibration of the fp32 GEGLU's card limit, 1e-5 of the output's peak
    against K2's plain version (fp32 products), at the card tests' widths:
    both GEMMs as three tf32 terms each meet it; one term each, or three with
    x_lo.Wp_hi, h_lo.Wo_hi or x_hi.Wp_lo dropped, miss it."""
    rng = np.random.default_rng(m + c)
    inner = 4 * c
    args = [torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)) for s, sc in (
        ((m, c), 1.0), ((2 * inner, c), c**-0.5), ((2 * inner,), 0.1), ((c, inner), inner**-0.5), ((c,), 0.1))]
    want = FF.geglu_ff_ref(*args)
    err = float((_tf32_geglu(*args, terms) - want).abs().max() / want.abs().max())
    assert (err <= 1e-5) == meets, err


def test_fp32_routes_reach_the_fp32_kernels(monkeypatch):
    """The routing of an fp32 SD-v1-width UNet on the card, with the launches
    mocked: meta tensors stand in for the card's (not the CPU's, so every
    wrapper takes its kernel route). An fp32 FeedForward with use_fused (as
    sd_v1_inpaint sets it) reaches the GEGLU launch in fp32 at C 320 (with a
    gradient) and 640, and K9's at 1280 without a gradient; fp32 attention with
    a gradient, through flash_attention and flash_attention_v2, reaches the
    tf32 forward (STATS, then the recompute) and K5's fp32 split pass, dQ and
    dK/dV kernels, and never a bf16-only launch. The GEGLU operand check takes
    fp32 at every K2 and K9 width."""
    from vface_torch.models.unet import FeedForward

    calls = []

    def ff_launch(name, widths, x, *weights, tm=None):
        FF._check_operands(name, widths, x, *weights)
        calls.append((name, x.dtype))
        return torch.empty_like(x)

    monkeypatch.setattr(FF, "_launch", ff_launch)
    for name in ("F32_LAUNCHES", "WIDE_F32_LAUNCHES", "LAUNCHES", "WIDE_LAUNCHES"):
        monkeypatch.setattr(FF, name, 0)
    for c, grad in ((320, True), (640, False), (1280, False), (1280, True)):
        ff = FeedForward(c, dtype=torch.float32, use_fused=True).to("meta")
        x = torch.empty(2, 64, c, device="meta", requires_grad=grad)
        with torch.set_grad_enabled(grad):
            out = ff(x)
        if grad:
            out.sum().backward()
    assert calls == [("geglu_ff", torch.float32), ("geglu_ff", torch.float32), ("geglu_ff_wide", torch.float32)]
    assert (FF.F32_LAUNCHES, FF.WIDE_F32_LAUNCHES, FF.LAUNCHES, FF.WIDE_LAUNCHES) == (2, 1, 0, 0)

    calls.clear()
    bf16_only = lambda kernel, *a, **kw: calls.append(("bf16", kernel))
    monkeypatch.setattr(FA, "_launch_fwd", bf16_only)
    monkeypatch.setattr(FA, "_launch_bwd", bf16_only)
    monkeypatch.setattr(FA, "_launch_f32", lambda kernel, stats, q, *a: calls.append((kernel, stats, q.dtype)))
    monkeypatch.setattr(FA, "_bwd_f32_planes",
                        lambda q, *a: calls.append(("split", q.dtype)) or torch.empty(1, device=q.device))
    monkeypatch.setattr(FA, "_launch_bwd_f32", lambda kernel, planes, q, *a: calls.append((kernel, q.dtype)))
    f32 = torch.float32
    for entry, fwd in ((FA.flash_attention, "flash_attention_stats_f32"), (FA.flash_attention_v2, "flash_attention_v2_stats")):
        calls.clear()
        leaves = [torch.empty(1, 4096, 320, device="meta", requires_grad=True) for _ in range(3)]
        entry(*leaves, 8).sum().backward()
        assert calls == [(fwd, True, f32), ("flash_attention_fp32_f32", False, f32), ("split", f32),
                         ("flash_attention_bwd_dq_f32", f32), ("flash_attention_bwd_dkv_f32", f32)]

    for c in (*FF.WIDTHS, *FF.WIDE_WIDTHS):
        args = [torch.zeros(s, dtype=f32) for s in ((8, c), (8 * c, c), (8 * c,), (c, 4 * c), (c,))]
        assert FF._check_operands("geglu_ff", (*FF.WIDTHS, *FF.WIDE_WIDTHS), *args) == (c, 4 * c)
    with pytest.raises(ValueError, match="dtype"):
        FF._check_operands("geglu_ff", FF.WIDTHS, *[a.half() for a in args])
