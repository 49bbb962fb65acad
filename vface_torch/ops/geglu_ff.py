"""Fused GEGLU feed-forward (kernel K2): CUDA C++ for Hopper, ``csrc/geglu_ff.cu``.

Replaces ``vface_tpu/ops/pallas_ff.py::geglu_ff`` (kernel ``_ff_kernel``):
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
version :func:`geglu_ff_ref` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native

MAX_C = 768  # the JAX package's routing: wider sites (ds4, C = 1280) take the plain version
WIDTHS = (64, 320, 640)  # the kernel's instantiations: ds1, ds2, and a small width for tests
INNER_CHUNK = 128

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def gelu_erf(x32: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in float32, in the TPU kernel's form."""
    return 0.5 * x32 * (1.0 + torch.erf(x32 * 0.7071067811865476))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with float32 accumulation and one rounding to a's dtype."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t()).to(a.dtype)


def geglu_ff_ref(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points (any dtype)."""
    inner = w_proj.shape[0] // 2
    gate = _mm(x, w_proj[inner:]) + b_proj[inner:]
    g = gelu_erf(gate.to(torch.float32)).to(x.dtype)
    a = _mm(x, w_proj[:inner]) + b_proj[:inner]
    return _mm(a * g, w_out) + b_out


def geglu_ff(x, w_proj, b_proj, w_out, b_out) -> torch.Tensor:
    """GEGLU FF over x (..., C); the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return geglu_ff_ref(x, w_proj, b_proj, w_out, b_out)
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"geglu_ff: unsupported device {x.device}")
    c = x.shape[-1]
    inner = w_proj.shape[0] // 2
    shapes = {"w_proj": (2 * inner, c), "b_proj": (2 * inner,), "w_out": (c, inner), "b_out": (c,)}
    for name, t in zip(shapes, (w_proj, b_proj, w_out, b_out)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"geglu_ff: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    for name, t in (("x", x), ("w_proj", w_proj), ("b_proj", b_proj), ("w_out", w_out), ("b_out", b_out)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"geglu_ff: {name} must be bf16 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu_ff: {name} must be contiguous and 16-byte aligned")
    if c not in WIDTHS or inner % INNER_CHUNK:
        raise ValueError(f"geglu_ff: C={c} must be one of {WIDTHS}, I={inner} a multiple of {INNER_CHUNK}")
    fn = _native.function("geglu_ff", "vface_geglu_ff_bf16", _ARGTYPES)
    x2 = x.reshape(-1, c)
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), w_out.data_ptr(),
             b_out.data_ptr(), out.data_ptr(), x2.shape[0], c, inner, stream)
    _native.check(err, "geglu_ff")
    LAUNCHES += 1
    return out.reshape(x.shape)
