"""The port's kernels on the card, each against its plain version, and their gradients.

These need an NVIDIA GPU with nvcc (Hopper, sm_90a); elsewhere they skip. Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` holds the same kernels to the same plain versions at the
swap path's full shapes.
"""

import math

import pytest
import torch

from vface_torch.ops import _archive_attention as AA
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


def _ulps(want, count=2):
    return count * 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)


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


def _check_k1_k4(q, k, v, heads):
    """K1 and K4 on (q, k, v) against their plain version: out within 2 bf16 ulps
    of its peak, K4's out bit-equal to K1's, m and l within 1e-5 relative."""
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, heads)
    out, m, l = FA.flash_attention_stats(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert FA.LAUNCHES["flash_attention_stats"] == before["flash_attention_stats"] + 1
    assert torch.equal(out, got)
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, heads)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max() <= _ulps(want)
    assert ((m - wm).abs() / wm.abs().clamp(min=1e-30)).max() <= 1e-5
    assert ((l - wl).abs() / wl).max() <= 1e-5


# K1's tiles are 128 or 192 query rows (two or three warpgroups of 64) by 64
# keys: Nq 1 and 65 leave warpgroups idle, 130 and 300 a ragged one; Nq != Nk
# both ways
@pytest.mark.parametrize("b,nq,nk,heads,dh", [
    (2, 1, 1, 2, 40), (2, 65, 65, 3, 8), (2, 130, 130, 3, 80), (2, 300, 300, 2, 40), (1, 128, 256, 2, 40),
    (2, 65, 300, 2, 80), (2, 300, 130, 4, 16), (3, 257, 1000, 2, 48), (2, 130, 300, 2, 160), (1, 1024, 1024, 8, 160),
    (2, 65, 65, 3, 152)])
def test_flash_attention_kernel_tiling(gen, b, nq, nk, heads, dh):
    q = _randn(gen, b, nq, heads * dh)
    k, v = (_randn(gen, b, nk, heads * dh) for _ in range(2))
    _check_k1_k4(q, k, v, heads)


@pytest.mark.parametrize("b,nq,nk,heads,dh", [(2, 300, 130, 2, 40), (1, 65, 300, 2, 80), (2, 130, 130, 3, 16)])
def test_forward_tiles_agree_bit_for_bit(gen, b, nq, nk, heads, dh):
    """The forward kernel at 128 and 192 query rows per CTA: each query row is
    computed by one warpgroup in the same order either way, so K1, K4 (m and l
    too) and K6 give the same bits at both tiles (K6 at dh 80 is built at 128
    rows only)."""
    q = _randn(gen, b, nq, heads * dh)
    k, v = (_randn(gen, b, nk, heads * dh) for _ in range(2))
    for split, stats in ((False, False), (False, True), (True, False)):
        got = []
        for nc in FA.CONSUMERS:
            if nc not in FA.built_consumers(split, dh):
                continue
            outs = (torch.empty_like(q),)
            if stats:
                outs += tuple(torch.empty((b * heads, nq), dtype=torch.float32, device="cuda") for _ in range(2))
            FA._launch_fwd("flash_attention", q, k, v, heads, outs, split, nc)
            got.append(outs)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got[0], got[-1]))


def test_flash_attention_kernel_reads_nothing_past_its_tensors(gen):
    """The last head's padded box (dh 40 in 48 columns) and the last tile's rows
    lie past the tensors' ends: each tensor is a view that ends at its storage's
    end, or one followed by NaNs. The kernel reads zeros there, so the
    output is finite and equal to the plain version's."""
    b, nq, nk, heads, dh = 2, 300, 130, 8, 40
    sizes = (b * nq * heads * dh, b * nk * heads * dh, b * nk * heads * dh)
    at_end = [_randn(gen, 8 + n)[8:] for n in sizes]
    nan_after = [torch.cat([_randn(gen, n), torch.full((4096,), float("nan"), device="cuda",
                                                        dtype=torch.bfloat16)])[:n] for n in sizes]
    for flat in (at_end, nan_after):
        q, k, v = (t.view(b, -1, heads * dh) for t in flat)
        _check_k1_k4(q, k, v, heads)


@pytest.mark.parametrize("b,n,c", [(12, 4096, 320), (12, 1024, 640)])
def test_flash_attention_kernel_unet_shapes(gen, b, n, c):
    """The swap's sampling batch at ds1 (dh 40) and ds2 (dh 80)."""
    q, k, v = (_randn(gen, b, n, c) for _ in range(3))
    _check_k1_k4(q, k, v, 8)


def test_kernels_reject_widths_they_are_not_built_for(gen):
    """dh 24 pads to 32 and C 128 is not a UNet width: no instantiation, so the wrappers raise."""
    q = _randn(gen, 1, 64, 2 * 24)
    with pytest.raises(ValueError, match="pads to"):
        FA.flash_attention(q, q, q, 2)
    args = (_randn(gen, 32, 128), _randn(gen, 1024, 128), _randn(gen, 1024), _randn(gen, 128, 512),
            _randn(gen, 128))
    with pytest.raises(ValueError, match="must be one of"):
        FF.geglu_ff(*args)


def _ff_args(gen, m, c):
    inner = 4 * c
    return (_randn(gen, m, c), _randn(gen, 2 * inner, c, scale=c**-0.5), _randn(gen, 2 * inner, scale=0.1),
            _randn(gen, c, inner, scale=inner**-0.5), _randn(gen, c, scale=0.1))


# C = 320 takes 64-row tiles below 128 * 132 rows and 128-row tiles from there
# (ragged at each, and M below one tile); C = 640 the two-kernel form on
# 128-row tiles; the train step's M = 4096 at both widths, the swap's full ds1
# and ds2 shapes (b = 12), and C = 64 on 128-row tiles
@pytest.mark.parametrize("m,c", [(4096 + 17, 320), (1000, 640), (64, 64), (128 * 132 + 17, 320), (17, 320),
                                 (4096, 320), (49152, 320), (17, 640), (4096, 640), (12288, 640), (300, 64)])
def test_geglu_ff_kernel(gen, m, c):
    """Ragged M; kernel and plain version round at the same four points, so the
    final rounding plus a flipped bf16 intermediate: 2 bf16 ulps at the output's peak."""
    args = _ff_args(gen, m, c)
    before = FF.LAUNCHES
    got = FF.geglu_ff(*args)
    torch.cuda.synchronize()
    assert FF.LAUNCHES == before + 1
    want = FF.geglu_ff_ref(*args).float()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want).abs().max() <= _ulps(want)


# whole segments; one partial segment; 56 whole segments and a partial one per
# row (the 720 x 1280 frames of the video path's background VAE), off-centre
@pytest.mark.parametrize("shape,offset", [((2, 128, 256, 256), 0.0), ((1, 3, 130, 70), 0.0),
                                          ((2, 4, 720, 1280), 0.5)])
def test_gn_sums_kernel(gen, shape, offset):
    """fp32 sums in another order: relative 1e-5 of the row's sum of |x|."""
    x = (_randn(gen, *shape).float() + offset).to(torch.bfloat16)
    s1, s2 = GN.gn_sums(x)
    r1, r2 = GN.gn_sums_ref(x)
    torch.cuda.synchronize()
    absx = x.float().abs().sum(dim=(2, 3))
    assert ((s1 - r1).abs() / absx).max() < 1e-5
    assert ((s2 - r2).abs() / r2).max() < 1e-5


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# K6 and K5 keep P and dS at fp32 precision: each output's relative L2 error
# against its fp32 plain version stays under this share of the error of the
# same plain version with P and dS rounded to bf16 alone (as in chip_smoke.py)
PRECISION_GATE = 0.25

# ragged N; dh pads to 48, 16, 80, 48, 160 (SD-v1's ds4 at 768^2: 576 tokens)
TRAIN_SHAPES = [(300, 2, 40), (130, 3, 16), (300, 2, 80), (130, 2, 48), (576, 2, 160)]
# K6, K7 and K5: the self-attention shapes at b = 2, then Nq != Nk both ways
# (ragged, a whole 128-row tile of queries over 320 keys, dh 16)
CROSS_SHAPES = [(2, n, n, heads, dh) for n, heads, dh in TRAIN_SHAPES] + [
    (2, 300, 130, 2, 40), (2, 128, 320, 2, 80), (2, 130, 300, 3, 16), (1, 1000, 257, 2, 48), (2, 300, 130, 2, 160),
    (1, 130, 1000, 3, 160)]
# K5 at dh 160 (64-row CTAs, 64-row streamed tiles): one row past a tile both
# ways, an odd count of tiles, and dh 152 (padded to 160 in shared memory)
WIDE_BWD_SHAPES = [(1, 65, 577, 2, 160), (1, 577, 65, 2, 160), (2, 191, 191, 2, 160), (1, 130, 300, 2, 152)]


def _qkv(gen, b, nq, nk, heads, dh, count=3):
    """q (b, nq, heads * dh), k and v (b, nk, ...), and with count 4 also dO (b, nq, ...)."""
    q = _randn(gen, b, nq, heads * dh)
    k, v = (_randn(gen, b, nk, heads * dh) for _ in range(2))
    return (q, k, v) if count == 3 else (q, k, v, _randn(gen, b, nq, heads * dh))


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


@pytest.mark.parametrize("b,nq,nk,heads,dh", CROSS_SHAPES)
def test_flash_attention_fp32_kernel(gen, b, nq, nk, heads, dh):
    """K6: P at fp32 precision (hi + lo bf16 products) vs the plain fp32 version:
    2 bf16 ulps of the output's peak (one rounding of the output, other sums),
    and the precision gate against K4's plain version (P rounded alone)."""
    q, k, v = _qkv(gen, b, nq, nk, heads, dh)
    got = FA.flash_attention_fp32(q, k, v, heads)
    torch.cuda.synchronize()
    want = FA.flash_attention_fp32_ref(q, k, v, heads)
    assert (got.float() - want.float()).abs().max() <= _ulps(want)
    yard = FA.flash_attention_stats_ref(q, k, v, heads)[0]
    assert _rel_l2(got, want) <= PRECISION_GATE * _rel_l2(yard, want)


@pytest.mark.parametrize("b,nq,nk,heads,dh", CROSS_SHAPES + WIDE_BWD_SHAPES)
def test_flash_attention_bwd_kernels(gen, b, nq, nk, heads, dh):
    """K5 (dQ and dK/dV kernels) vs the plain version on the same m, l and D:
    each gradient within 2 bf16 ulps of its peak, and the precision gate
    against the plain version with P and dS rounded alone."""
    q, k, v, do = _qkv(gen, b, nq, nk, heads, dh, count=4)
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


@pytest.mark.parametrize("b,nq,nk,heads,dh", [(1, 4096, 4096, 8, 40), (2, 300, 130, 2, 80), (1, 1024, 1024, 8, 160),
                                             (1, 577, 65, 2, 160), (2, 65, 577, 2, 160)])
def test_flash_attention_bwd_kernels_are_deterministic(gen, b, nq, nk, heads, dh):
    """K5 sums each output in a fixed order in one CTA: two launches on the same
    inputs give the same bits."""
    q, k, v, do = _qkv(gen, b, nq, nk, heads, dh, count=4)
    _, m, l = FA.flash_attention_stats(q, k, v, heads)
    dd = FA.rowsum_do_o(do, FA.flash_attention_fp32(q, k, v, heads), heads)
    first = FA.flash_attention_bwd(q, k, v, do, m, l, dd, heads)
    second = FA.flash_attention_bwd(q, k, v, do, m, l, dd, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


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
        "flash_attention_v1": 0, "flash_attention_v3": 0, "flash_attention_v4": 0, "flash_attention_v6": 0,
        **F32_NONE}
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


# the fp32 forms' launch keys, none launched by a bf16 path
F32_NONE = dict.fromkeys(("flash_attention_stats_f32", "flash_attention_fp32_f32", "flash_attention_bwd_dq_f32",
                          "flash_attention_bwd_dkv_f32"), 0)


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("nq,nk,heads,dh,dtype", [
    (300, 300, 2, 40, torch.float32), (130, 70, 3, 16, torch.float32), (257, 1000, 2, 80, torch.float32),
    (64, 200, 4, 32, torch.float32), (300, 130, 2, 40, torch.bfloat16), (1024, 1024, 8, 80, torch.bfloat16),
    (333, 100, 2, 40, torch.float32), (200, 130, 3, 32, torch.bfloat16), (576, 576, 2, 160, torch.float32),
    (300, 1000, 2, 160, torch.float32), (1024, 1024, 8, 160, torch.bfloat16)])
def test_flash_attention_v1_kernel(gen, nq, nk, heads, dh, dtype):
    """K8 (ragged Nq and Nk, Nq != Nk both ways, every head width) vs its plain
    version over the same fp32 math: fp32 on the tf32 kernel within 1e-5 of the
    output's peak (three tf32 terms per product leave ~2^-21 relative; one term
    errs by ~1e-3, tests/test_torch_kernels.py); bf16 within 2 bf16 ulps (both
    round the same fp32 value once), on K6's kernel or, at dh 32, the tf32 one."""
    q, k, v = _rand(gen, 2, nq, heads * dh, dtype=dtype), *(_rand(gen, 2, nk, heads * dh, dtype=dtype) for _ in "kv")
    before = FA.LAUNCHES["flash_attention_v1"]
    got = FA._flash_attention_v1(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_v1"] == before + 1 and got.dtype == dtype
    want = FA.flash_attention_v1_ref(q, k, v, heads)
    tol = 1e-5 * want.float().abs().max().item() if dtype == torch.float32 else _ulps(want)
    assert (got.float() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("nq,nk,heads,dh,dtype", [(300, 300, 2, 40, torch.float32), (257, 1000, 2, 80, torch.float32),
                                                 (333, 100, 2, 16, torch.float32), (257, 1000, 2, 160, torch.float32)])
def test_flash_attention_v1_kernel_is_deterministic(gen, nq, nk, heads, dh, dtype):
    """The tf32 kernel walks each row's keys in one fixed order: two launches
    (each with its own split pass) are equal bit for bit."""
    q, k, v = _rand(gen, 2, nq, heads * dh, dtype=dtype), *(_rand(gen, 2, nk, heads * dh, dtype=dtype) for _ in "kv")
    assert torch.equal(FA._flash_attention_v1(q, k, v, heads), FA._flash_attention_v1(q, k, v, heads))


@pytest.mark.parametrize("nq,nk,heads,dh", [(300, 130, 2, 40), (1024, 1024, 8, 80), (130, 300, 3, 16)])
def test_k8_on_bf16_operands_is_k6s_kernel(gen, nq, nk, heads, dh):
    """bf16 K8, K10 and K11 launch K6's kernel (its SPLIT instantiation computes
    their function): their outputs are K6's bit for bit, counted under their own keys."""
    q, k, v = _randn(gen, 2, nq, heads * dh), *(_randn(gen, 2, nk, heads * dh) for _ in "kv")
    want = FA.flash_attention_fp32(q, k, v, heads)
    for name, fn in (("flash_attention_v1", lambda: FA._flash_attention_v1(q, k, v, heads)),
                     ("flash_attention_v3", lambda: AA.flash_attention_v3(q, k, v, heads, 1, 1)),
                     ("flash_attention_v4", lambda: AA.flash_attention_v4(q, k, v, heads, 1, 1))):
        before = dict(FA.LAUNCHES)
        got = fn()
        assert {key: FA.LAUNCHES[key] - before[key] for key in before if FA.LAUNCHES[key] != before[key]} == {name: 1}
        assert torch.equal(got, want)


@pytest.mark.parametrize("nq,nk,heads,dh,dtype", [
    (300, 300, 2, 40, torch.bfloat16), (130, 130, 3, 16, torch.bfloat16), (300, 300, 2, 80, torch.bfloat16),
    (300, 300, 2, 40, torch.float32), (130, 130, 3, 32, torch.float32), (300, 130, 2, 40, torch.bfloat16),
    (128, 320, 2, 80, torch.bfloat16), (130, 300, 3, 16, torch.bfloat16), (300, 130, 2, 40, torch.float32),
    (576, 576, 2, 160, torch.bfloat16), (300, 130, 2, 160, torch.float32)])
def test_flash_attention_v2_stats_kernel(gen, nq, nk, heads, dh, dtype):
    """K7: bf16, K6's output bit for bit; fp32, K8's (the tf32 kernel). Against the plain version:
    out within 2 bf16 ulps (bf16) or 1e-5 of its peak (fp32), m and l within
    1e-5 relative; Nq != Nk both ways."""
    q = _rand(gen, 2, nq, heads * dh, dtype=dtype)
    k, v = (_rand(gen, 2, nk, heads * dh, dtype=dtype) for _ in range(2))
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
    without a gradient launches K8 (v5's function at fp32); with one, on fp32
    operands, flash_attention and flash_attention_v2 launch the tf32 forward
    (STATS: K7's fp32 form), the tf32 recompute and K5's fp32 kernels, each
    gradient within 1e-5 of its peak of the same autograd graph through the
    plain versions (tests/test_torch_kernels.py calibrates the limit)."""
    heads, dh, n = 2, 40, 300
    leaves = [_randn(gen, 1, n, heads * dh).requires_grad_(True) for _ in range(3)]
    do = _randn(gen, 1, n, heads * dh)
    before = dict(FA.LAUNCHES)
    FA.flash_attention_v2(*leaves, heads, 300, 300).backward(do)
    torch.cuda.synchronize()
    assert {k: FA.LAUNCHES[k] - before[k] for k in before} == {
        "flash_attention": 0, "flash_attention_stats": 0, "flash_attention_fp32": 1, "flash_attention_v2_stats": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1, "flash_attention_v1": 0,
        "flash_attention_v3": 0, "flash_attention_v4": 0, "flash_attention_v6": 0, **F32_NONE}
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
    q, k, v, do = (_rand(gen, 2, n, heads * dh) for _ in range(4))
    for entry, fwd in ((FA.flash_attention, "flash_attention_stats_f32"),
                       (lambda *a: FA.flash_attention_v2(*a, 300, 300), "flash_attention_v2_stats")):
        grads = []
        for fn in (entry, FA.flash_attention_ref if fwd.endswith("f32") else None):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = dict(FA.LAUNCHES)
            if fn is None:  # v2's plain path: K7's plain forward, the plain backward
                FA._FlashAttention.apply(*leaves, heads, True, FA.flash_attention_v2_stats_ref).backward(do)
            else:
                fn(*leaves, heads).backward(do)
            torch.cuda.synchronize()
            launched = {k_: FA.LAUNCHES[k_] - before[k_] for k_ in before if FA.LAUNCHES[k_] != before[k_]}
            grads.append(([x.grad for x in leaves], launched))
        (got, launched), (want, none) = grads
        assert launched == {fwd: 1, "flash_attention_fp32_f32": 1, "flash_attention_bwd_dq_f32": 1,
                            "flash_attention_bwd_dkv_f32": 1} and none == {}
        for gi, wi in zip(got, want):
            assert gi.dtype == torch.float32 and (gi - wi).abs().max() <= 1e-5 * wi.abs().max()


@pytest.mark.parametrize("m,c", [(3072, 1280), (1000, 1024), (17, 1280), (768, 1280)])
def test_geglu_ff_wide_kernel(gen, m, c):
    """K9, ragged M, against K2's plain version (K9 computes K2's function):
    2 bf16 ulps at the output's peak, the final rounding plus a flipped
    bf16 intermediate. The ds4 site at b = 12, the middle block's, M below a tile."""
    args = _ff_args(gen, m, c)
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
    b = _randn(gen, 1, 64, 2 * 24)  # dh 24 pads to 32: K5 is built for 16, 48, 80
    st = torch.zeros((2, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="pads to"):
        FA.flash_attention_bwd(b, b, b, b, st, st + 1, st, 2)
    g = _rand(gen, 1, 64, 80).requires_grad_(True)
    with pytest.raises(ValueError, match="gradient"):  # v2 and v5 take fp32 gradients (K5's fp32 kernels)
        FA.flash_attention_v1(g, g, g, 2)
    g24 = _rand(gen, 1, 64, 2 * 24)
    with pytest.raises(ValueError, match="must be one of"):
        FA.flash_attention_bwd(g24, g24, g24, g24, st, st + 1, st, 2)
    args = [_randn(gen, 32, 768), _randn(gen, 6144, 768), _randn(gen, 6144), _randn(gen, 768, 3072),
            _randn(gen, 768)]
    with pytest.raises(ValueError, match="must be one of"):
        FF.geglu_ff_wide(*args)
    args = [_randn(gen, 32, 1024).requires_grad_(True), _randn(gen, 8192, 1024), _randn(gen, 8192),
            _randn(gen, 1024, 4096), _randn(gen, 1024)]
    with pytest.raises(ValueError, match="gradient"):
        FF.geglu_ff_wide(*args)


@pytest.mark.parametrize("name", ["flash_attention_v3", "flash_attention_v4", "flash_attention_v6"])
@pytest.mark.parametrize("n,heads,dh,dtype", [(256, 4, 40, torch.float32), (256, 4, 40, torch.bfloat16),
                                              (1024, 8, 80, torch.bfloat16)])
def test_archive_kernels(gen, name, n, heads, dh, dtype):
    """K10/K11 (K8's kernels: K6's for bf16, the tf32 one for fp32) and K12 (K1's
    kernel for bf16, the tf32 one for fp32), each
    counted under its own key, against its plain version on the same blocks:
    fp32 within 1e-5 of the output's peak, bf16 within 2 ulps."""
    q, k, v = (_rand(gen, 2, n, heads * dh, dtype=dtype) for _ in range(3))
    before = dict(FA.LAUNCHES)
    got = getattr(AA, name)(q, k, v, heads, block_q=128, block_k=64)
    torch.cuda.synchronize()
    assert {key: FA.LAUNCHES[key] - before[key] for key in before if FA.LAUNCHES[key] != before[key]} == {name: 1}
    if name == "flash_attention_v6" and dtype == torch.bfloat16:
        want = FA.flash_attention_ref(q, k, v, heads)
    else:
        want = FA.flash_attention_v1_ref(q, k, v, heads, block_k=64)
    tol = 1e-5 * want.float().abs().max().item() if dtype == torch.float32 else _ulps(want)
    assert got.dtype == dtype and (got.float() - want.float()).abs().max() <= tol


def test_archive_kernels_refuse_what_they_do_not_take(gen):
    """v6 on bf16 runs K1, Nq != Nk included (fp32 takes K8); no variant has a
    gradient on the card. The port's flash_attention has one at Nq != Nk (K4,
    then K6 and K5): within 2 bf16 ulps of each gradient's peak of the same
    autograd graph through the plain versions."""
    q, kv = _randn(gen, 1, 128, 80), _randn(gen, 1, 64, 80)
    before = FA.LAUNCHES["flash_attention_v6"]
    got = AA.flash_attention_v6(q, kv, kv, 2, 64, 64)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_v6"] == before + 1
    want = FA.flash_attention_ref(q, kv, kv, 2)
    assert (got.float() - want.float()).abs().max() <= _ulps(want)
    qf, kvf = q.float(), kv.float()
    assert AA.flash_attention_v6(qf, kvf, kvf, 2, 64, 64).shape == qf.shape
    g = _rand(gen, 1, 64, 80).requires_grad_(True)
    for fn in (AA.flash_attention_v3, AA.flash_attention_v4, AA.flash_attention_v6):
        with pytest.raises(ValueError, match="gradient"):
            fn(g, g, g, 2, 64, 64)
    do = _randn(gen, 1, 128, 80)
    grads = []
    for fn in (FA.flash_attention, FA.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, kv, kv)]
        fn(*leaves, 2).backward(do)
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all()) and (got.float() - want.float()).abs().max() <= _ulps(want)


@pytest.mark.parametrize("c,m", [(320, 1000), (640, 1000), (320, 17), (640, 17)])
def test_geglu_ff_split_kernel(gen, c, m):
    """K13 at every built row tile, ragged M and M below a tile: against K2's
    plain version within 2 bf16 ulps of the output's peak; the tile K2 takes
    for this M is K2's kernel, bit for bit (at C = 640 the two-kernel form)."""
    args = _ff_args(gen, m, c)
    want = FF.geglu_ff_ref(*args).float()
    for tm in FF.SPLIT_TILES[c]:
        before = FF.SPLIT_LAUNCHES
        got = FF.geglu_ff_split(*args, tm)
        torch.cuda.synchronize()
        assert FF.SPLIT_LAUNCHES == before + 1
        assert (got.float() - want).abs().max() <= _ulps(want), tm
        if c not in FF.FUSED_WIDTHS or tm == FF.k2_tile(m, got.device):
            assert torch.equal(got, FF.geglu_ff(*args))
    with pytest.raises(ValueError, match="no kernel"):
        FF.geglu_ff_split(*args, 32)


@pytest.mark.parametrize("c,m", [(320, 1000), (640, 1000), (320, 17)])
def test_geglu_ff_split_kernel_fp32(gen, c, m):
    """K13 on fp32 operands at its built tile (K2's fp32 two-kernel form):
    within 1e-5 of the output's peak of K2's plain version, K2's fp32 output
    bit for bit, one SPLIT_F32_LAUNCHES count a call."""
    args = tuple(a.float() for a in _ff_args(gen, m, c))
    want = FF.geglu_ff_ref(*args)
    before = FF.SPLIT_F32_LAUNCHES
    got = FF.geglu_ff_split(*args, 128)
    torch.cuda.synchronize()
    assert FF.SPLIT_F32_LAUNCHES == before + 1 and got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, FF.geglu_ff(*args))
    with pytest.raises(ValueError, match="no kernel"):
        FF.geglu_ff_split(*args, 64)  # bf16's tile at C = 320 only


def test_unet_wide_feed_forward_takes_k9_only_without_a_gradient(gen):
    """The UNet's wide sites (C = 1280, use_fused as sd_v1_inpaint sets it):
    K9 under inference mode, within 2 bf16 ulps of its plain version; the
    unfused route, and no K9 launch, while a gradient is recorded."""
    from vface_torch.models.unet import FeedForward

    ff = FeedForward(1280, dtype=torch.bfloat16, use_fused=True).cuda()
    assert ff.use_wide and not ff.use_fused
    for p in ff.parameters():
        p.data = torch.randn(p.shape, generator=gen, device="cuda") * p.shape[-1] ** -0.5
    x = _randn(gen, 2, 384, 1280)
    w = (ff.geglu.proj.weight.bfloat16(), ff.geglu.proj.bias.bfloat16(), ff.proj_out.weight.bfloat16(),
         ff.proj_out.bias.bfloat16())
    before = FF.WIDE_LAUNCHES
    with torch.inference_mode():
        got = ff(x)
    torch.cuda.synchronize()
    assert FF.WIDE_LAUNCHES == before + 1
    want = FF.geglu_ff_ref(x, *w).float()
    assert (got.float() - want).abs().max() <= _ulps(want)
    xg = x.clone().requires_grad_(True)
    out = ff(xg)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert FF.WIDE_LAUNCHES == before + 1 and xg.grad is not None
    unfused = FF.geglu_ff_unfused(x, *w).float()
    assert (out.detach().float() - unfused).abs().max() <= _ulps(unfused)


# K5 on fp32 at every built head width: self-attention shapes with a ragged
# tile, Nq != Nk both ways, Nq and Nk below one tile
F32_BWD_SHAPES = [(2, 300, 300, 2, 40), (2, 130, 70, 3, 16), (2, 257, 1000, 2, 80), (2, 64, 200, 4, 32),
                  (2, 300, 130, 2, 40), (1, 1000, 257, 2, 80), (2, 17, 33, 2, 16), (1, 1024, 1024, 8, 80),
                  (2, 576, 576, 2, 160), (2, 130, 300, 2, 160), (1, 1024, 1024, 8, 160), (1, 65, 577, 2, 160),
                  (1, 577, 65, 2, 160), (2, 191, 191, 2, 160), (1, 33, 33, 1, 160)]


@pytest.mark.parametrize("b,nq,nk,heads,dh", F32_BWD_SHAPES)
def test_flash_attention_bwd_f32_kernels(gen, b, nq, nk, heads, dh):
    """K5's fp32 kernels (3xTF32) vs the plain version on the same m, l and D:
    each gradient within 1e-5 of its peak (three tf32 terms per product meet
    it, one term or a dropped lo term miss it: tests/test_torch_kernels.py),
    and two launches equal bit for bit (each output summed in a fixed order)."""
    q, k, v, do = _rand(gen, b, nq, heads * dh), *(_rand(gen, b, nk, heads * dh) for _ in "kv"), \
        _rand(gen, b, nq, heads * dh)
    _, m, l = FA.flash_attention_stats(q, k, v, heads)
    dd = FA.rowsum_do_o(do, FA.flash_attention_fp32(q, k, v, heads), heads)
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, do, m, l, dd, heads)
    again = FA.flash_attention_bwd(q, k, v, do, m, l, dd, heads)
    torch.cuda.synchronize()
    assert {key: FA.LAUNCHES[key] - before[key] for key in before if FA.LAUNCHES[key] != before[key]} == {
        "flash_attention_bwd_dq_f32": 2, "flash_attention_bwd_dkv_f32": 2}
    want = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, heads)
    for gi, ai, wi in zip(got, again, want):
        assert gi.dtype == torch.float32 and torch.equal(gi, ai)
        assert (gi - wi).abs().max() <= 1e-5 * wi.abs().max()


@pytest.mark.parametrize("b,nq,nk,heads,dh", [(2, 300, 130, 2, 40), (2, 130, 300, 3, 80), (2, 130, 300, 2, 160)])
def test_fp32_forward_forms_of_k4_and_k6(gen, b, nq, nk, heads, dh):
    """On fp32 operands K4 (flash_attention_stats) runs the tf32 kernel's STATS
    form and K6 (flash_attention_fp32) its plain form, under their own keys:
    the same output bit for bit (K4's P rounding is a no-op at fp32), within
    1e-5 of the peak of K4's plain version; m and l within 1e-5 relative."""
    q, k, v = _rand(gen, b, nq, heads * dh), *(_rand(gen, b, nk, heads * dh) for _ in "kv")
    before = dict(FA.LAUNCHES)
    out, m, l = FA.flash_attention_stats(q, k, v, heads)
    o6 = FA.flash_attention_fp32(q, k, v, heads)
    torch.cuda.synchronize()
    assert {key: FA.LAUNCHES[key] - before[key] for key in before if FA.LAUNCHES[key] != before[key]} == {
        "flash_attention_stats_f32": 1, "flash_attention_fp32_f32": 1}
    assert torch.equal(out, o6)
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, heads)
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()
    assert ((m - wm).abs() / wm.abs().clamp(min=1e-30)).max() <= 1e-5
    assert ((l - wl).abs() / wl).max() <= 1e-5


# The dh-160 forwards' schedules: a half-empty last query tile (576 rows are
# 4.5 tiles of 128) and a ragged last key tile, both ways; more tiles than the
# card has SMs (12 x 8 heads x 5 tiles: a persistent CTA walks several); dh 152
# (padded to 160 in shared memory)
WIDE_FWD_SHAPES = [(1, 65, 577, 2, 160), (1, 577, 65, 2, 160), (2, 576, 576, 2, 160), (12, 576, 576, 8, 160),
                   (1, 300, 577, 3, 152)]
# the tf32 forward at dh 160 on clusters of two CTAs per 128 query rows (b =
# 1 at 1024^2, ragged both ways, a half-empty last tile) and, past one wave,
# one CTA per 128 rows (flash_attention.f32_cluster)
WIDE_F32_FWD_SHAPES = [(1, 1024, 1024, 8, 160), (1, 65, 577, 2, 160), (1, 577, 65, 2, 160), (2, 576, 576, 2, 160),
                       (12, 576, 576, 8, 160)]


def _check_ml(m, l, wm, wl):
    assert ((m - wm).abs() / wm.abs().clamp(min=1e-30)).max() <= 1e-5
    assert ((l - wl).abs() / wl).max() <= 1e-5


@pytest.mark.parametrize("b,nq,nk,heads,dh", WIDE_FWD_SHAPES)
def test_wide_bf16_forward_forms(gen, b, nq, nk, heads, dh):
    """The bf16 forward kernel at dh 160: K4's output is K1's and K7's is
    K6's bit for bit, a second launch gives the same bits, K1 and K6 are
    within 2 bf16 ulps of their plain versions (P rounded to bf16, P at fp32),
    m and l within 1e-5 relative."""
    q = _randn(gen, b, nq, heads * dh)
    k, v = (_randn(gen, b, nk, heads * dh) for _ in range(2))
    k1 = FA.flash_attention(q, k, v, heads)
    o4, m4, l4 = FA.flash_attention_stats(q, k, v, heads)
    k6 = FA.flash_attention_fp32(q, k, v, heads)
    o7, m7, l7 = FA.flash_attention_v2_stats(q, k, v, heads)
    k1b, k6b = FA.flash_attention(q, k, v, heads), FA.flash_attention_fp32(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.equal(o4, k1) and torch.equal(o7, k6) and torch.equal(k1b, k1) and torch.equal(k6b, k6)
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, heads)
    want6 = FA.flash_attention_fp32_ref(q, k, v, heads)
    assert bool(torch.isfinite(k1).all()) and bool(torch.isfinite(k6).all())
    assert (k1.float() - want.float()).abs().max() <= _ulps(want)
    assert (k6.float() - want6.float()).abs().max() <= _ulps(want6)
    _check_ml(m4, l4, wm, wl)
    _check_ml(m7, l7, wm, wl)


@pytest.mark.parametrize("b,nq,nk,heads,dh", WIDE_F32_FWD_SHAPES)
def test_wide_tf32_forward_forms(gen, b, nq, nk, heads, dh):
    """The tf32 forward kernel at dh 160 on fp32 operands: K8, K4, K6 and K7
    give the same output bit for bit, a second launch the same bits, within
    1e-5 of the plain version's peak; m and l within 1e-5 relative."""
    q, k, v = _rand(gen, b, nq, heads * dh), *(_rand(gen, b, nk, heads * dh) for _ in "kv")
    o8 = FA._flash_attention_v1(q, k, v, heads)
    o4, m4, l4 = FA.flash_attention_stats(q, k, v, heads)
    o6 = FA.flash_attention_fp32(q, k, v, heads)
    o7, m7, l7 = FA.flash_attention_v2_stats(q, k, v, heads)
    again = FA._flash_attention_v1(q, k, v, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(o, o8) for o in (o4, o6, o7, again))
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, heads)
    assert (o8 - want).abs().max() <= 1e-5 * want.abs().max()
    _check_ml(m4, l4, wm, wl)
    _check_ml(m7, l7, wm, wl)


def _ff_args_f32(gen, m, c):
    inner = 4 * c
    return (_rand(gen, m, c), _rand(gen, 2 * inner, c) * c**-0.5, _rand(gen, 2 * inner) * 0.1,
            _rand(gen, c, inner) * inner**-0.5, _rand(gen, c) * 0.1)


# K2's widths (64, 320, 640) and K9's (1024, 1280) on fp32: ragged M, M below
# one 128-row tile, the swap's ds1 site and the ds4 one at b = 12
@pytest.mark.parametrize("m,c", [(4096 + 17, 320), (1000, 640), (300, 64), (17, 320), (49152, 320),
                                 (17, 1280), (1000, 1024), (3072, 1280), (768 + 5, 1280)])
def test_geglu_ff_f32_kernels(gen, m, c):
    """K2 and K9 on fp32 operands (3xTF32 GEMMs) vs K2's plain version in fp32:
    within 1e-5 of the output's peak (calibrated in tests/test_torch_kernels.py),
    counted under their fp32 keys, two launches equal bit for bit."""
    args = _ff_args_f32(gen, m, c)
    wide = c in FF.WIDE_WIDTHS
    fn = FF.geglu_ff_wide if wide else FF.geglu_ff
    before = (FF.F32_LAUNCHES, FF.WIDE_F32_LAUNCHES, FF.LAUNCHES, FF.WIDE_LAUNCHES)
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    after = (FF.F32_LAUNCHES, FF.WIDE_F32_LAUNCHES, FF.LAUNCHES, FF.WIDE_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == ((0, 2, 0, 0) if wide else (2, 0, 0, 0))
    want = FF.geglu_ff_ref(*args)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # the row-tile kernels (K13) on fp32 are built at tm 128 only
    with pytest.raises(ValueError, match="no kernel at C=320, tm=64 for torch.float32"):
        FF.geglu_ff_split(*_ff_args_f32(gen, 17, 320), 64)


# the crops' VAE sites (short rows; whole-cluster rows), an unaligned row start
# (130 * 70 elements), the HD frames' 921,600-element rows, fp16
@pytest.mark.parametrize("shape,dtype", [((2, 128, 256, 256), torch.bfloat16), ((1, 3, 130, 70), torch.bfloat16),
                                         ((2, 4, 720, 1280), torch.bfloat16), ((6, 512, 128, 128), torch.bfloat16),
                                         ((2, 128, 256, 256), torch.float32), ((1, 3, 130, 70), torch.float32),
                                         ((2, 4, 720, 1280), torch.float32), ((3, 5, 33, 7), torch.float16)])
def test_gn_sums_kernel_dtypes_and_determinism(gen, shape, dtype):
    """K3, one launch a call: relative 1e-5 of each row's sum of |x| (sums) and
    of the sum of squares, against the plain version; two launches equal bit
    for bit (a row's partial sums added in rank order, no atomics)."""
    x = (torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dtype)
    before = GN.LAUNCHES
    s1, s2 = GN.gn_sums(x)
    a1, a2 = GN.gn_sums(x)
    torch.cuda.synchronize()
    assert GN.LAUNCHES == before + 2
    assert torch.equal(s1, a1) and torch.equal(s2, a2)
    r1, r2 = GN.gn_sums_ref(x)
    absx = x.float().abs().sum(dim=(2, 3))
    assert ((s1 - r1).abs() / absx).max() < 1e-5
    assert ((s2 - r2).abs() / r2).max() < 1e-5
