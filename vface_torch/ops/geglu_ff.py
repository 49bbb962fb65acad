"""GEGLU feed-forward (kernels K2, K9 and K13): CUDA C++ for Hopper, ``csrc/geglu_ff.cu``.

K2 replaces ``vface_tpu/ops/pallas_ff.py::geglu_ff`` (kernel ``_ff_kernel``):
``proj_out(a * gelu_erf(gate))`` with ``[a | gate] = proj(x)``, rounded to the
compute dtype at the same four points as the TPU kernel:

    gate = bf16(x @ Wg) + bg;  g = bf16(gelu_erf(f32(gate)))
    a    = bf16(x @ Wa) + ba;  out = bf16((a * g) @ Wo) + bo

where the bias adds are adds in the compute dtype after the round (at fp32
every round is a no-op: the JAX kernels round at x's dtype). Weights are
in PyTorch's Linear layout: ``w_proj`` (2I, C) with rows [0, I) the A half and
[I, 2I) the gate half, ``w_out`` (C, I).

On the H100 the op is tensor-core bound (6*M*C*I FLOPs) once the weights
reach the SMs fast enough; see the source for the designs. K2 runs the fused
kernel at C = 64 and 320 (the (M, I) gated intermediate stays in shared memory
chunk by chunk, so device memory sees x, the weights and the output only) on
128-row tiles, or 64-row tiles when M is small (:func:`k2_tile`). At C = 640
it runs the two-kernel form, which the card measured faster than a fused
kernel there (PERF.md, K2): GEMM 1 writes h = bf16(a * g) to an (M, I)
scratch tensor, GEMM 2 computes ``h @ Wo.T + bo``; h is the value the fused
kernel feeds to its second product, so the function does not change.

:func:`geglu_ff` launches the kernel for a CUDA tensor and calls the plain
version :func:`geglu_ff_ref` for a CPU tensor. fp32 operands (K2's and K9's
widths) take the two-kernel form on the tensor cores as 3xTF32: every product
three tf32 terms of hi + lo splits, with a split pass over the weights, h kept
in fp32, and each 32-column block's product added to the running sum on the
CUDA cores; they count under ``F32_LAUNCHES`` (K2) and ``WIDE_F32_LAUNCHES``
(K9). Where a gradient is needed it
is differentiable with the JAX package's VJP (``pallas_ff.py::_geglu_ff_bwd``):
the forward is the kernel, the backward autograd through
:func:`geglu_ff_unfused`, a copy of the unfused ``_ref_impl`` (one 2I-wide
product, the bias added in the compute dtype, ``a * gelu(gate)``), not through
the kernel's split rounding.

K9 :func:`geglu_ff_wide` replaces ``pallas_ff.py::_pallas_impl_wide`` (kernel
``_ff_kernel_wide``): K2's function at the wide sites (C = 1280 at ds4 and in
the middle block), the second product accumulated in fp32 over the whole
inner dimension and rounded once, on the two-kernel form. JAX defines no VJP
for it: on the card a call that needs a gradient raises. The JAX package
keeps it unwired and sends C > 768 to ``_ref_impl``; the port's UNet sends
those sites to K9 when no gradient is recorded (K9 beat the unfused route at
both of them on the card, PERF.md, K9) and to :func:`geglu_ff_unfused` when
one is.

K13 :func:`geglu_ff_split` replaces ``scripts/bench_ff_tile.py::_pallas_split``
(kernel ``_ff_kernel_split``, ``_ff_kernel``'s body line for line), the TPU
kernel of the row-tile sweep: K2's kernel at a row tile ``tm`` chosen by the
caller among the ones built (``SPLIT_TILES``): the fused kernel at C = 320,
the two-kernel form (128 rows) at C = 640. fp32 operands (the JAX kernel
computes at any dtype) take K2's fp32 two-kernel form, whose 3xTF32 GEMMs run
on 128-row tiles (``tm`` = 128 only), and count under ``SPLIT_F32_LAUNCHES``.
Its plain version is K2's.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad

MAX_C = 768  # the JAX package's routing: wider sites (ds4, C = 1280) take the unfused path
WIDTHS = (64, 320, 640)  # K2's: ds1, ds2, and a small width for tests
WIDE_WIDTHS = (1024, 1280)  # K9's: ds4 and the middle block, and the JAX test's width
FUSED_WIDTHS = (64, 320)  # K2 on the fused kernel; at 640 on the two-kernel form (PERF.md, K2)
INNER_CHUNK = 128

# K13's row tiles by width, K2's kernels: the fused kernel's instantiations at
# C = 320, none of which spills, and the two-kernel form's tile at C = 640
SPLIT_TILES = {320: (64, 128), 640: (128,)}

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0  # K2
WIDE_LAUNCHES = 0  # K9
SPLIT_LAUNCHES = 0  # K13
SPLIT_F32_LAUNCHES = 0  # K13 on fp32 operands
F32_LAUNCHES = 0  # K2 on fp32 operands
WIDE_F32_LAUNCHES = 0  # K9 on fp32 operands

_FUSED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_TWO_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_TWO_F32_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def k2_tile(m: int, device: torch.device) -> int:
    """K2's row tile at C = 320 on a CUDA device: 128 rows, or 64 where 128-row
    tiles would fill at most half of the SMs (PERF.md, K2)."""
    return 64 if m <= 64 * torch.cuda.get_device_properties(device).multi_processor_count else 128


def gelu_erf(x32: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in float32, in the TPU kernel's form."""
    return 0.5 * x32 * (1.0 + torch.erf(x32 * 0.7071067811865476))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with float32 accumulation and one rounding to a's dtype."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t()).to(a.dtype)


def geglu_ff_ref(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points (any dtype);
    where a gradient is needed, with the kernel's backward."""
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        return _GegluFF.apply(x, w_proj, b_proj, w_out, b_out, True)
    return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)


def _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    inner = w_proj.shape[0] // 2
    gate = _mm(x, w_proj[inner:]) + b_proj[inner:]
    g = gelu_erf(gate.to(torch.float32)).to(x.dtype)
    a = _mm(x, w_proj[:inner]) + b_proj[:inner]
    return _mm(a * g, w_out) + b_out


def geglu_ff_unfused(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """The JAX package's unfused path (``pallas_ff.py::_ref_impl``, the GEGLU and
    Dense modules): ``h = x @ w_proj.T + b_proj`` rounded to x's dtype with the
    bias added in it, ``a * gelu_erf(gate)`` with the GELU in float32, then the
    output product. Plain PyTorch, differentiable by autograd; it is the
    backward of the fused wrappers and the route of every FeedForward that JAX
    does not send to its fused kernel."""
    inner = w_proj.shape[0] // 2
    h = torch.matmul(x, w_proj.t()) + b_proj
    a, gate = h[..., :inner], h[..., inner:]
    return torch.matmul(a * gelu_erf(gate.to(torch.float32)).to(x.dtype), w_out.t()) + b_out


class _GegluFF(torch.autograd.Function):
    """Forward: the kernel (``plain``: its plain version); backward: autograd
    through :func:`geglu_ff_unfused` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w_proj, b_proj, w_out, b_out, plain: bool):
        ctx.save_for_backward(x, w_proj, b_proj, w_out, b_out)
        return (_geglu_ff_plain if plain else _geglu_ff)(x, w_proj, b_proj, w_out, b_out)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = geglu_ff_unfused(*inputs)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted], g)
        result = [None] * 6
        for i, gi in zip(wanted, grads):
            result[i] = gi
        return tuple(result)


def geglu_ff(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """GEGLU FF over x (..., C); the kernel on CUDA, the plain version on the CPU;
    differentiable with the JAX VJP where a gradient is needed."""
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        return _GegluFF.apply(x, w_proj, b_proj, w_out, b_out, False)
    return _geglu_ff(x, w_proj, b_proj, w_out, b_out)


def _check_operands(name: str, widths, x, w_proj, b_proj, w_out, b_out):
    """Raise unless the operands are what a kernel takes: one dtype, bf16 or
    fp32, on x's device, contiguous and 16-byte aligned, C in ``widths``, I a
    multiple of ``INNER_CHUNK``; returns (C, I)."""
    dtype = x.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {dtype}")
    c = x.shape[-1]
    inner = w_proj.shape[0] // 2
    shapes = {"w_proj": (2 * inner, c), "b_proj": (2 * inner,), "w_out": (c, inner), "b_out": (c,)}
    for arg, t in zip(shapes, (w_proj, b_proj, w_out, b_out)):
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shapes[arg]}")
    for arg, t in (("x", x), ("w_proj", w_proj), ("b_proj", b_proj), ("w_out", w_out), ("b_out", b_out)):
        if t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be {dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    if c not in widths or inner % INNER_CHUNK:
        raise ValueError(f"{name}: C={c} must be one of {widths}, I={inner} a multiple of {INNER_CHUNK}")
    return c, inner


def _launch(name: str, widths, x, w_proj, b_proj, w_out, b_out, tm=None) -> torch.Tensor:
    """Check the operands; launch the fused kernel at row tile ``tm``, or with
    ``tm`` None the two-kernel form; fp32 operands take the two-kernel form's
    3xTF32 GEMMs (``tm`` None)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    c, inner = _check_operands(name, widths, x, w_proj, b_proj, w_out, b_out)
    dtype = x.dtype
    x2 = x.reshape(-1, c)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x2.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out.data_ptr())
    if dtype == torch.float32:
        h = torch.empty((x2.shape[0], inner), dtype=dtype, device=x.device)  # GEMM 1's (a + ba) * gelu(gate + bg)
        planes = torch.empty(6 * c * inner, dtype=dtype, device=x.device)  # the weights' tf32 hi and lo
        fn = _native.function("geglu_ff", "vface_geglu_ff_two_f32", _TWO_F32_ARGTYPES)
        err = fn(*ptrs, h.data_ptr(), planes.data_ptr(), x2.shape[0], c, inner, stream)
    elif tm is not None:
        fn = _native.function("geglu_ff", "vface_geglu_ff_fused_bf16", _FUSED_ARGTYPES)
        err = fn(*ptrs, x2.shape[0], c, inner, tm, stream)
    else:
        h = torch.empty((x2.shape[0], inner), dtype=x.dtype, device=x.device)  # GEMM 1's a*g
        fn = _native.function("geglu_ff", "vface_geglu_ff_two_bf16", _TWO_ARGTYPES)
        err = fn(*ptrs, h.data_ptr(), x2.shape[0], c, inner, stream)
    _native.check(err, name)
    return out.reshape(x.shape)


def _geglu_ff(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    global LAUNCHES, F32_LAUNCHES
    c, m = x.shape[-1], x.numel() // max(x.shape[-1], 1)
    if x.dtype == torch.float32:
        out = _launch("geglu_ff", WIDTHS, x, w_proj, b_proj, w_out, b_out)
        F32_LAUNCHES += 1
        return out
    tm = (k2_tile(m, x.device) if c == 320 else 128) if c in FUSED_WIDTHS else None
    out = _launch("geglu_ff", WIDTHS, x, w_proj, b_proj, w_out, b_out, tm)
    LAUNCHES += 1
    return out


def geglu_ff_wide(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """K9: GEGLU FF over x (..., C) at C in ``WIDE_WIDTHS``; the kernel on CUDA
    (no gradient; bf16, or fp32 on the 3xTF32 GEMMs). K9 computes K2's function, so its plain version, used on the
    CPU, is K2's: :func:`geglu_ff_ref`."""
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        raise ValueError("geglu_ff_wide: no gradient (the JAX package defines no VJP for "
                         "_pallas_impl_wide); use geglu_ff_unfused")
    global WIDE_LAUNCHES, WIDE_F32_LAUNCHES
    out = _launch("geglu_ff_wide", WIDE_WIDTHS, x, w_proj, b_proj, w_out, b_out)
    if x.dtype == torch.float32:
        WIDE_F32_LAUNCHES += 1
    else:
        WIDE_LAUNCHES += 1
    return out


def geglu_ff_split(x, w_proj, b_proj, w_out, b_out, tm: int) -> torch.Tensor:
    """K13: K2's function over x (..., C) with the kernel's row tile set to ``tm``
    rows, one of ``SPLIT_TILES[C]`` (bf16; at fp32 the 128-row tile of K2's
    fp32 form; any other ``tm`` raises); the kernel on CUDA (no gradient), K2's
    plain version :func:`geglu_ff_ref` on the CPU."""
    c = x.shape[-1]
    f32 = x.dtype == torch.float32
    if tm not in SPLIT_TILES.get(c, ()) or (f32 and tm != 128):
        raise ValueError(f"geglu_ff_split: no kernel at C={c}, tm={tm} for {x.dtype}; built: {SPLIT_TILES}, "
                         "fp32 at 128 rows")
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        raise ValueError("geglu_ff_split: no gradient (the bench kernel has no VJP); use geglu_ff")
    global SPLIT_LAUNCHES, SPLIT_F32_LAUNCHES
    out = _launch("geglu_ff_split", tuple(SPLIT_TILES), x, w_proj, b_proj, w_out, b_out,
                  tm if c in FUSED_WIDTHS and not f32 else None)
    if f32:
        SPLIT_F32_LAUNCHES += 1
    else:
        SPLIT_LAUNCHES += 1
    return out
