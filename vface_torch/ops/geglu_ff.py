"""Fused GEGLU feed-forward (kernels K2 and K9): CUDA C++ for Hopper, ``csrc/geglu_ff.cu``.

K2 replaces ``vface_tpu/ops/pallas_ff.py::geglu_ff`` (kernel ``_ff_kernel``):
``proj_out(a * gelu_erf(gate))`` with ``[a | gate] = proj(x)``, rounded to the
compute dtype at the same four points as the TPU kernel:

    gate = bf16(x @ Wg) + bg;  g = bf16(gelu_erf(f32(gate)))
    a    = bf16(x @ Wa) + ba;  out = bf16((a * g) @ Wo) + bo

where the bias adds are adds in the compute dtype after the round. Weights are
in PyTorch's Linear layout: ``w_proj`` (2I, C) with rows [0, I) the A half and
[I, 2I) the gate half, ``w_out`` (C, I).

On the H100 the fused op is tensor-core bound (6*M*C*I FLOPs); the kernel
keeps the (M, I) gated intermediate in shared memory chunk by chunk, so device
memory sees x, the weights and the output only. See the source for the tiling.

:func:`geglu_ff` launches the kernel for a CUDA tensor and calls the plain
version :func:`geglu_ff_ref` for a CPU tensor. Where a gradient is needed it
is differentiable with the JAX package's VJP (``pallas_ff.py::_geglu_ff_bwd``):
the forward is the kernel, the backward autograd through
:func:`geglu_ff_unfused`, a copy of the unfused ``_ref_impl`` (one 2I-wide
product, the bias added in the compute dtype, ``a * gelu(gate)``), not through
the kernel's split rounding.

K9 :func:`geglu_ff_wide` replaces ``pallas_ff.py::_pallas_impl_wide`` (kernel
``_ff_kernel_wide``): K2's function at the wide sites (C = 1280 at ds4 and in
the middle block), the second product accumulated in fp32 over the whole
inner dimension and rounded once. The JAX package keeps it unwired and sends
C > 768 to ``_ref_impl``; so does the port's UNet, through
:func:`geglu_ff_unfused` (bf16 products with fp32 accumulation on the card),
until the card's times decide otherwise. JAX defines no VJP for it: on the
card a call that needs a gradient raises.

K13 :func:`geglu_ff_split` replaces ``scripts/bench_ff_tile.py::_pallas_split``
(kernel ``_ff_kernel_split``, ``_ff_kernel``'s body line for line), the TPU
kernel of the row-tile sweep: K2's kernel at a row tile ``tm`` chosen by the
caller among the ones compiled (``SPLIT_TILES``). Its plain version is K2's.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad

MAX_C = 768  # the JAX package's routing: wider sites (ds4, C = 1280) take the unfused path
WIDTHS = (64, 320, 640)  # K2's instantiations: ds1, ds2, and a small width for tests
WIDE_WIDTHS = (1024, 1280)  # K9's: ds4 and the middle block, and the JAX test's width
INNER_CHUNK = 128

# K13's row tiles by width: the instantiations that compile without spills
SPLIT_TILES = {320: (16, 32, 64), 640: (16, 32)}

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0  # K2
WIDE_LAUNCHES = 0  # K9
SPLIT_LAUNCHES = 0  # K13

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def _launch(name: str, symbol: str, widths, x, w_proj, b_proj, w_out, b_out, *tile) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    c = x.shape[-1]
    inner = w_proj.shape[0] // 2
    shapes = {"w_proj": (2 * inner, c), "b_proj": (2 * inner,), "w_out": (c, inner), "b_out": (c,)}
    for arg, t in zip(shapes, (w_proj, b_proj, w_out, b_out)):
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shapes[arg]}")
    for arg, t in (("x", x), ("w_proj", w_proj), ("b_proj", b_proj), ("w_out", w_out), ("b_out", b_out)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be bf16 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    if c not in widths or inner % INNER_CHUNK:
        raise ValueError(f"{name}: C={c} must be one of {widths}, I={inner} a multiple of {INNER_CHUNK}")
    fn = _native.function("geglu_ff", symbol, _SPLIT_ARGTYPES if tile else _ARGTYPES)
    x2 = x.reshape(-1, c)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), w_out.data_ptr(),
             b_out.data_ptr(), out.data_ptr(), x2.shape[0], c, inner, *tile, stream)
    _native.check(err, name)
    return out.reshape(x.shape)


def _geglu_ff(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    global LAUNCHES
    out = _launch("geglu_ff", "vface_geglu_ff_bf16", WIDTHS, x, w_proj, b_proj, w_out, b_out)
    LAUNCHES += 1
    return out


def geglu_ff_wide(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """K9: GEGLU FF over x (..., C) at C in ``WIDE_WIDTHS``; the kernel on CUDA
    (no gradient). K9 computes K2's function, so its plain version, used on the
    CPU, is K2's: :func:`geglu_ff_ref`."""
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        raise ValueError("geglu_ff_wide: no gradient (the JAX package defines no VJP for "
                         "_pallas_impl_wide); use geglu_ff_unfused")
    global WIDE_LAUNCHES
    out = _launch("geglu_ff_wide", "vface_geglu_ff_wide_bf16", WIDE_WIDTHS, x, w_proj, b_proj, w_out, b_out)
    WIDE_LAUNCHES += 1
    return out


def geglu_ff_split(x, w_proj, b_proj, w_out, b_out, tm: int) -> torch.Tensor:
    """K13: K2's function over x (..., C) with the kernel's row tile set to ``tm``
    rows, one of ``SPLIT_TILES[C]`` (any other ``tm`` raises); the kernel on
    CUDA (no gradient), K2's plain version :func:`geglu_ff_ref` on the CPU."""
    c = x.shape[-1]
    if tm not in SPLIT_TILES.get(c, ()):
        raise ValueError(f"geglu_ff_split: no kernel at C={c}, tm={tm}; built: {SPLIT_TILES}")
    if x.device.type == "cpu":
        return _geglu_ff_plain(x, w_proj, b_proj, w_out, b_out)
    if needs_grad(x, w_proj, b_proj, w_out, b_out):
        raise ValueError("geglu_ff_split: no gradient (the bench kernel has no VJP); use geglu_ff")
    global SPLIT_LAUNCHES
    out = _launch("geglu_ff_split", "vface_geglu_ff_split_bf16", tuple(SPLIT_TILES), x, w_proj, b_proj, w_out,
                  b_out, tm)
    SPLIT_LAUNCHES += 1
    return out
