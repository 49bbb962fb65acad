"""GroupNorm statistics (kernel K3): a Triton reduction for Hopper.

Replaces ``vface_tpu/models/layers.py::_gn_sums_pallas`` (kernel
``_gn_sums_kernel``): one pass over an activation giving the float32 sum and
sum of squares per (batch, channel). The port keeps activations NCHW, so each
(b, c) pair is one contiguous row of H*W elements.

On the H100 the op is bound by device-memory bytes (two flops per element
read). The TPU kernel walked row blocks in order on one core, carrying the sums
in a resident output block; here the rows are split into segments so that
thousands of programs stream the tensor at once: pass 1, grid (B*C, splits),
writes one float32 partial pair per segment; pass 2, grid (B*C,), adds each
row's partials in a fixed order. No atomics, so the result is the same from
run to run.

:func:`gn_sums` launches the kernels for a CUDA tensor and calls the plain
version :func:`gn_sums_ref` for a CPU tensor. ``triton`` is imported only when
a kernel is launched. Where a gradient is needed it is differentiable with the
JAX package's VJP (``layers.py::_gn_sums_bwd``): dx = ds1 + 2*x32*ds2 in
float32, cast to x's dtype, plain PyTorch (the JAX backward is no kernel).
"""

from __future__ import annotations

import functools

import torch

from vface_torch.ops._autograd import needs_grad

BLOCK = 2048  # elements per load step of one program
SEGMENT = 16384  # elements of one row per program in pass 1

LAUNCHES = 0  # wrapper launches (both passes) since the last reset


def gn_sums_ref(x: torch.Tensor):
    """Plain version: (sum, sum of squares) over the spatial dims of NCHW x, float32 (B, C)."""
    x32 = x.to(torch.float32)
    dims = tuple(range(2, x.ndim))
    return x32.sum(dim=dims), (x32 * x32).sum(dim=dims)


@functools.lru_cache(maxsize=1)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def partial_sums(x_ptr, p1_ptr, p2_ptr, length, seg, splits, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        sp = tl.program_id(1)
        base = x_ptr + row.to(tl.int64) * length
        start = sp * seg
        lanes = tl.arange(0, BLOCK)
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, seg, BLOCK):
            idx = start + off + lanes
            val = tl.load(base + idx, mask=idx < length, other=0.0).to(tl.float32)
            acc1 += val
            acc2 += val * val
        out = row.to(tl.int64) * splits + sp
        tl.store(p1_ptr + out, tl.sum(acc1, axis=0))
        tl.store(p2_ptr + out, tl.sum(acc2, axis=0))

    @triton.jit
    def finish(p1_ptr, p2_ptr, s1_ptr, s2_ptr, splits, SPLITS: tl.constexpr):
        row = tl.program_id(0)
        lanes = tl.arange(0, SPLITS)
        mask = lanes < splits
        base = row.to(tl.int64) * splits
        a = tl.load(p1_ptr + base + lanes, mask=mask, other=0.0)
        b = tl.load(p2_ptr + base + lanes, mask=mask, other=0.0)
        tl.store(s1_ptr + row, tl.sum(a, axis=0))
        tl.store(s2_ptr + row, tl.sum(b, axis=0))

    return triton, partial_sums, finish


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
    """(sum, sum of squares) per (b, c) of NCHW x; Triton on CUDA, the plain
    version on the CPU; differentiable where a gradient is needed."""
    if needs_grad(x):
        return _GNSums.apply(x)
    return _gn_sums(x)


def _gn_sums(x: torch.Tensor):
    if x.device.type == "cpu":
        return gn_sums_ref(x)
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(f"gn_sums: unsupported device {x.device}")
    if x.ndim != 4 or x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"gn_sums: x must be a 4-D bf16/fp16/fp32 NCHW tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gn_sums: x must be contiguous NCHW")
    triton, partial_sums, finish = _kernels()
    b, c, h, w = x.shape
    rows, length = b * c, h * w
    splits = triton.cdiv(length, SEGMENT)
    p1 = torch.empty((rows, splits), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    partial_sums[(rows, splits)](x, p1, p2, length, SEGMENT, splits, BLOCK=BLOCK, num_warps=8)
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    finish[(rows,)](p1, p2, s1, s2, splits, SPLITS=max(triton.next_power_of_2(splits), 16), num_warps=1)
    LAUNCHES += 1
    return s1, s2
