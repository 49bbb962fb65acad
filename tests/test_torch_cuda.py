"""The port's kernels on the card, each against its plain version.

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
    before = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
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
