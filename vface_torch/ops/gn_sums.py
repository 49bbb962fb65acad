"""GroupNorm statistics (kernel K3): CUDA C++ for Hopper, ``csrc/gn_sums.cu``.

Replaces ``vface_tpu/models/layers.py::_gn_sums_pallas`` (kernel
``_gn_sums_kernel``): one pass over an activation giving the float32 sum and
sum of squares per (batch, channel). The port keeps activations NCHW, so each
(b, c) pair is one contiguous row of H*W elements (bf16, fp16 or fp32).

On the H100 the op is bound by device-memory bytes (two flops per element
read). One launch streams every row: a short row takes one CTA, a long one a
thread-block cluster whose CTAs' partial sums CTA 0 adds in rank order through
distributed shared memory; no atomics and no partial-sum tensor, so the
result is the same from run to run (see the source).

:func:`gn_sums` launches the kernel for a CUDA tensor and calls the plain
version :func:`gn_sums_ref` for a CPU tensor. Where a gradient is needed it is
differentiable with the JAX package's VJP (``layers.py::_gn_sums_bwd``):
dx = ds1 + 2*x32*ds2 in float32, cast to x's dtype, plain PyTorch (the JAX
backward is no kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad

LAUNCHES = 0  # kernel launches since the last reset

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the kernel's dtype codes
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _entry():
    """The C entry point, looked up once: the op runs ~150 times a video window,
    and a row of 16384 elements takes the card only ~0.04 ms."""
    return _native.function("gn_sums", "vface_gn_sums", _ARGTYPES)


def gn_sums_ref(x: torch.Tensor):
    """Plain version: (sum, sum of squares) over the spatial dims of NCHW x, float32 (B, C)."""
    x32 = x.to(torch.float32)
    dims = tuple(range(2, x.ndim))
    return x32.sum(dim=dims), (x32 * x32).sum(dim=dims)


class _GNSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gn_sums(x)

    @staticmethod
    def backward(ctx, ds1, ds2):
        (x,) = ctx.saved_tensors
        dx = ds1[:, :, None, None] + 2.0 * x.to(torch.float32) * ds2[:, :, None, None]
        return dx.to(x.dtype)


def gn_sums(x: torch.Tensor):
    """(sum, sum of squares) per (b, c) of NCHW x; the kernel on CUDA, the plain
    version on the CPU; differentiable where a gradient is needed."""
    if needs_grad(x):
        return _GNSums.apply(x)
    return _gn_sums(x)


def _gn_sums(x: torch.Tensor):
    # a lean host path: at the VAE's (6, 512, 128, 128) site the kernel takes
    # the card ~0.037 ms, so the wrapper's own time sets the call's pace
    if not x.is_cuda:
        if x.device.type == "cpu":
            return gn_sums_ref(x)
        raise ValueError(f"gn_sums: unsupported device {x.device}")
    global LAUNCHES
    code = _DTYPES.get(x.dtype)
    if x.ndim != 4 or code is None:
        raise ValueError(f"gn_sums: x must be a 4-D bf16/fp16/fp32 NCHW tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gn_sums: x must be contiguous NCHW")
    b, c, h, w = x.shape
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())  # torch.cuda.current_stream(...).cuda_stream
    err = _entry()(x.data_ptr(), out.data_ptr(), code, b * c, h * w, stream)
    if err:
        _native.check(err, "gn_sums")
    LAUNCHES += 1
    return out[0], out[1]
