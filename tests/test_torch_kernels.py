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
    before = mod.LAUNCHES
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
    assert mod.LAUNCHES == before


def test_nvcc_build_is_deferred_and_content_addressed():
    """Importing the ops compiles nothing; the library name hashes source and flags."""
    from vface_torch.ops import _native

    assert _native._libs == {}
    paths = {name: _native.lib_path(name) for name in _native.SOURCES}
    assert all(p.parent == _native.BUILD_DIR and p.suffix == ".so" for p in paths.values())
    assert len(set(paths.values())) == len(_native.SOURCES)
