"""The port's kernels on the card, each against its plain version, and their gradients.

These need an NVIDIA GPU with nvcc and triton (Hopper, sm_90a); elsewhere they
skip. Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` holds the same kernels to the same plain versions at the
swap path's full shapes.
"""

import math

import pytest
import torch

from vface_torch.ops import flash_attention as FA
from vface_torch.ops import geglu_ff as FF
from vface_torch.ops import gn_sums as GN

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("n,heads,dh", [(300, 2, 40), (1024, 8, 80), (130, 3, 8)])
def test_flash_attention_kernel(gen, n, heads, dh):
    """Ragged N and every padding case of dh. Kernel and plain version round the
    same fp32 values; another summation order may flip one bf16 rounding of P or
    of the output: tolerance 2 bf16 ulps at the output's peak."""
    q, k, v = (_randn(gen, 2, n, heads * dh) for _ in range(3))
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    want = FA.flash_attention_ref(q, k, v, heads).float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got.float() - want).abs().max() <= 2 * ulp


def test_kernels_reject_widths_they_are_not_built_for(gen):
    """dh 24 pads to 32 and C 128 is not a UNet width: no instantiation, so the wrappers raise."""
    q = _randn(gen, 1, 64, 2 * 24)
    with pytest.raises(ValueError, match="pads to"):
        FA.flash_attention(q, q, q, 2)
    args = (_randn(gen, 32, 128), _randn(gen, 1024, 128), _randn(gen, 1024), _randn(gen, 128, 512),
            _randn(gen, 128))
    with pytest.raises(ValueError, match="must be one of"):
        FF.geglu_ff(*args)


@pytest.mark.parametrize("m,c", [(4096 + 17, 320), (1000, 640), (64, 64)])
def test_geglu_ff_kernel(gen, m, c):
    """Ragged M; tolerance: bf16 rounding flips of intermediates, atol 3e-2 at |out| ~ 1."""
    inner = 4 * c
    args = (_randn(gen, m, c), _randn(gen, 2 * inner, c, scale=c**-0.5), _randn(gen, 2 * inner, scale=0.1),
            _randn(gen, c, inner, scale=inner**-0.5), _randn(gen, c, scale=0.1))
    got = FF.geglu_ff(*args)
    torch.cuda.synchronize()
    assert (got.float() - FF.geglu_ff_ref(*args).float()).abs().max() < 3e-2


@pytest.mark.parametrize("shape", [(2, 128, 256, 256), (1, 3, 130, 70)])
def test_gn_sums_kernel(gen, shape):
    """fp32 sums in another order: relative 1e-5 of the row's sum of |x|."""
    x = _randn(gen, *shape)
    s1, s2 = GN.gn_sums(x)
    r1, r2 = GN.gn_sums_ref(x)
    torch.cuda.synchronize()
    absx = x.float().abs().sum(dim=(2, 3))
    assert ((s1 - r1).abs() / absx).max() < 1e-5
    assert ((s2 - r2).abs() / r2).max() < 1e-5


def _ulps(want, count=2):
    return count * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# K6 and K5 keep P and dS at fp32 precision: each output's relative L2 error
# against its fp32 plain version stays under this share of the error of the
# same plain version with P and dS rounded to bf16 alone (as in chip_smoke.py)
PRECISION_GATE = 0.25

TRAIN_SHAPES = [(300, 2, 40), (130, 3, 16), (300, 2, 80), (130, 2, 48)]  # ragged N; dh pads to 48, 16, 80, 48


@pytest.mark.parametrize("n,heads,dh", TRAIN_SHAPES)
def test_flash_attention_stats_kernel(gen, n, heads, dh):
    """K4: its output is K1's bit for bit; against the plain version, out within
    2 bf16 ulps of its peak, m (the exact row max of the same fp32 scores, in
    another summation order) and l within 1e-5 relative."""
    q, k, v = (_randn(gen, 2, n, heads * dh) for _ in range(3))
    before = FA.LAUNCHES["flash_attention_stats"]
    out, m, l = FA.flash_attention_stats(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_stats"] == before + 1
    assert torch.equal(out, FA.flash_attention(q, k, v, heads))
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, heads)
    assert (out.float() - want.float()).abs().max() <= _ulps(want)
    assert ((m - wm).abs() / wm.abs().clamp(min=1e-30)).max() <= 1e-5
    assert ((l - wl).abs() / wl).max() <= 1e-5


@pytest.mark.parametrize("n,heads,dh", TRAIN_SHAPES)
def test_flash_attention_fp32_kernel(gen, n, heads, dh):
    """K6: P at fp32 precision (hi + lo bf16 products) vs the plain fp32 version:
    2 bf16 ulps of the output's peak (one rounding of the output, other sums),
    and the precision gate against K4's plain version (P rounded alone)."""
    q, k, v = (_randn(gen, 2, n, heads * dh) for _ in range(3))
    got = FA.flash_attention_fp32(q, k, v, heads)
    torch.cuda.synchronize()
    want = FA.flash_attention_fp32_ref(q, k, v, heads)
    assert (got.float() - want.float()).abs().max() <= _ulps(want)
    yard = FA.flash_attention_stats_ref(q, k, v, heads)[0]
    assert _rel_l2(got, want) <= PRECISION_GATE * _rel_l2(yard, want)


@pytest.mark.parametrize("n,heads,dh", TRAIN_SHAPES)
def test_flash_attention_bwd_kernels(gen, n, heads, dh):
    """K5 (dQ and dK/dV kernels) vs the plain version on the same m, l and D:
    each gradient within 2 bf16 ulps of its peak, and the precision gate
    against the plain version with P and dS rounded alone."""
    q, k, v, do = (_randn(gen, 2, n, heads * dh) for _ in range(4))
    _, m, l = FA.flash_attention_stats(q, k, v, heads)
    dd = FA.rowsum_do_o(do, FA.flash_attention_fp32(q, k, v, heads), heads)
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, do, m, l, dd, heads)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert FA.LAUNCHES[name] == before[name] + 1
    want = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, heads)
    yard = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, heads, round_p=True)
    for gi, wi, yi in zip(got, want, yard):
        assert gi.dtype == torch.bfloat16 and (gi.float() - wi.float()).abs().max() <= _ulps(wi)
        assert _rel_l2(gi, wi) <= PRECISION_GATE * _rel_l2(yi, wi)


def test_gradients_flow_through_every_wrapper(gen):
    """requires_grad inputs get finite gradients through K4/K6/K5, K2 and K3, each
    close to the same backward with the plain versions; a no-grad call is K1."""
    heads, dh, n = 8, 40, 1024
    leaves = [_randn(gen, 1, n, heads * dh).requires_grad_(True) for _ in range(3)]
    do = _randn(gen, 1, n, heads * dh)
    before = dict(FA.LAUNCHES)
    FA.flash_attention(*leaves, heads).backward(do)
    torch.cuda.synchronize()
    assert {k: FA.LAUNCHES[k] - before[k] for k in before} == {
        "flash_attention": 0, "flash_attention_stats": 1, "flash_attention_fp32": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1, "flash_attention_v2_stats": 0,
        "flash_attention_v1": 0}
    grads = [x.grad for x in leaves]
    for x in leaves:
        x.grad = None
    FA.flash_attention_ref(*leaves, heads).backward(do)
    for got, x in zip(grads, leaves):
        assert got is not None and bool(torch.isfinite(got).all()) and got.abs().max() > 0
        assert (got.float() - x.grad.float()).abs().max() <= _ulps(x.grad)
    with torch.no_grad():
        FA.flash_attention(*leaves, heads)
    assert FA.LAUNCHES["flash_attention"] == before["flash_attention"] + 1

    c, inner = 320, 1280
    args = [_randn(gen, 256, c), _randn(gen, 2 * inner, c, scale=c**-0.5), _randn(gen, 2 * inner, scale=0.1),
            _randn(gen, c, inner, scale=inner**-0.5), _randn(gen, c, scale=0.1)]
    args = [a.requires_grad_(True) for a in args]
    g = _randn(gen, 256, c)
    before_ff = FF.LAUNCHES
    FF.geglu_ff(*args).backward(g)
    assert FF.LAUNCHES == before_ff + 1
    grads = [a.grad for a in args]
    for a in args:
        a.grad = None
    FF.geglu_ff_ref(*args).backward(g)
    for got, a in zip(grads, args):
        assert got is not None and bool(torch.isfinite(got).all())
        assert torch.equal(got, a.grad)  # the same backward on the same saved inputs

    x = _randn(gen, 1, 128, 128, 128).requires_grad_(True)
    w1, w2 = torch.randn(2, 1, 128, generator=gen, device="cuda")
    before_gn = GN.LAUNCHES
    s1, s2 = GN.gn_sums(x)
    (s1 * w1 + s2 * w2).sum().backward()
    assert GN.LAUNCHES == before_gn + 1
    want = (w1[:, :, None, None] + 2.0 * x.detach().float() * w2[:, :, None, None]).to(torch.bfloat16)
    assert torch.equal(x.grad, want)


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("nq,nk,heads,dh,dtype", [
    (300, 300, 2, 40, torch.float32), (130, 70, 3, 16, torch.float32), (257, 1000, 2, 80, torch.float32),
    (64, 200, 4, 32, torch.float32), (300, 130, 2, 40, torch.bfloat16), (1024, 1024, 8, 80, torch.bfloat16)])
def test_flash_attention_v1_kernel(gen, nq, nk, heads, dh, dtype):
    """K8 (ragged Nq and Nk, Nq != Nk, every head width) vs its plain version
    over the same fp32 math: fp32 within 1e-5 of the output's peak (summation
    order only); bf16 within 2 bf16 ulps (both round the same fp32 value once)."""
    q, k, v = _rand(gen, 2, nq, heads * dh, dtype=dtype), *(_rand(gen, 2, nk, heads * dh, dtype=dtype) for _ in "kv")
    before = FA.LAUNCHES["flash_attention_v1"]
    got = FA._flash_attention_v1(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_v1"] == before + 1 and got.dtype == dtype
    want = FA.flash_attention_v1_ref(q, k, v, heads)
    tol = 1e-5 * want.float().abs().max().item() if dtype == torch.float32 else _ulps(want)
    assert (got.float() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("n,heads,dh,dtype", [(300, 2, 40, torch.bfloat16), (130, 3, 16, torch.bfloat16),
                                              (300, 2, 80, torch.bfloat16), (300, 2, 40, torch.float32),
                                              (130, 3, 32, torch.float32)])
def test_flash_attention_v2_stats_kernel(gen, n, heads, dh, dtype):
    """K7: bf16, K6's output bit for bit; fp32, K8's. Against the plain version:
    out within 2 bf16 ulps (bf16) or 1e-5 of its peak (fp32), m and l within
    1e-5 relative."""
    q, k, v = (_rand(gen, 2, n, heads * dh, dtype=dtype) for _ in range(3))
    before = FA.LAUNCHES["flash_attention_v2_stats"]
    out, m, l = FA.flash_attention_v2_stats(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_v2_stats"] == before + 1
    same = FA.flash_attention_fp32 if dtype == torch.bfloat16 else FA._flash_attention_v1
    assert torch.equal(out, same(q, k, v, heads))
    want, wm, wl = FA.flash_attention_v2_stats_ref(q, k, v, heads)
    tol = _ulps(want) if dtype == torch.bfloat16 else 1e-5 * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max() <= tol
    assert ((m - wm).abs() / wm.abs().clamp(min=1e-30)).max() <= 1e-5
    assert ((l - wl).abs() / wl).max() <= 1e-5


def test_flash_attention_v2_gradients_and_fp32_route(gen):
    """v2 with a gradient: K7 forward, K6 + K5 backward, the same gradients as
    the plain path within 2 ulps. The port's flash_attention on fp32 operands
    without a gradient launches K8 (v5's function at fp32)."""
    heads, dh, n = 2, 40, 300
    leaves = [_randn(gen, 1, n, heads * dh).requires_grad_(True) for _ in range(3)]
    do = _randn(gen, 1, n, heads * dh)
    before = dict(FA.LAUNCHES)
    FA.flash_attention_v2(*leaves, heads, 300, 300).backward(do)
    torch.cuda.synchronize()
    assert {k: FA.LAUNCHES[k] - before[k] for k in before} == {
        "flash_attention": 0, "flash_attention_stats": 0, "flash_attention_fp32": 1, "flash_attention_v2_stats": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1, "flash_attention_v1": 0}
    grads = [x.grad for x in leaves]
    for x in leaves:
        x.grad = None
    FA._FlashAttention.apply(*leaves, heads, True, FA.flash_attention_v2_stats_ref).backward(do)
    for got, x in zip(grads, leaves):
        assert (got.float() - x.grad.float()).abs().max() <= _ulps(x.grad)
    q = _rand(gen, 2, 256, heads * dh)
    with torch.no_grad():
        got = FA.flash_attention(q, q, q, heads)
    assert FA.LAUNCHES["flash_attention_v1"] == before["flash_attention_v1"] + 1
    want = FA.flash_attention_ref(q, q, q, heads)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("m,c", [(3072, 1280), (1000, 1024), (17, 1280)])
def test_geglu_ff_wide_kernel(gen, m, c):
    """K9, ragged M, against K2's plain version (K9 computes K2's function):
    2 bf16 ulps at the output's peak, the final rounding plus a flipped
    bf16 intermediate."""
    inner = 4 * c
    args = (_randn(gen, m, c), _randn(gen, 2 * inner, c, scale=c**-0.5),
            _randn(gen, 2 * inner, scale=0.1), _randn(gen, c, inner, scale=inner**-0.5), _randn(gen, c, scale=0.1))
    before = FF.WIDE_LAUNCHES
    got = FF.geglu_ff_wide(*args)
    torch.cuda.synchronize()
    assert FF.WIDE_LAUNCHES == before + 1
    want = FF.geglu_ff_ref(*args).float()
    assert (got.float() - want).abs().max() <= _ulps(want)


def test_new_wrappers_refuse_what_their_kernels_do_not_take(gen):
    """Widths without an instantiation, dtypes, and gradients: raise, never fall back."""
    q = _rand(gen, 1, 64, 2 * 24)  # dh 24: K8 is built for 16, 32, 40, 80
    with pytest.raises(ValueError, match="must be one of"):
        FA.flash_attention_v1(q, q, q, 2)
    h = _rand(gen, 1, 64, 2 * 40, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_v1(h, h, h, 2)
    b = _randn(gen, 1, 64, 80)
    with pytest.raises(ValueError, match="k must be"):  # K7 at bf16 is self-attention
        FA.flash_attention_v2_stats(b, b[:, :32], b[:, :32], 2)
    g = _rand(gen, 1, 64, 80).requires_grad_(True)
    for fn in (FA.flash_attention_v1, FA.flash_attention_v2, FA.flash_attention):
        with pytest.raises(ValueError, match="gradient"):
            fn(g, g, g, 2)
    args = [_randn(gen, 32, 768), _randn(gen, 6144, 768), _randn(gen, 6144), _randn(gen, 768, 3072),
            _randn(gen, 768)]
    with pytest.raises(ValueError, match="must be one of"):
        FF.geglu_ff_wide(*args)
    args = [_randn(gen, 32, 1024).requires_grad_(True), _randn(gen, 8192, 1024), _randn(gen, 8192),
            _randn(gen, 1024, 4096), _randn(gen, 1024)]
    with pytest.raises(ValueError, match="gradient"):
        FF.geglu_ff_wide(*args)
