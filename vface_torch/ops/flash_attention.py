"""Flash self-attention (kernel K1): CUDA C++ for Hopper, ``csrc/flash_attention.cu``.

Replaces ``vface_tpu/ops/pallas_attention.py::flash_attention_v5`` (kernel
``_flash_kernel_v5``). Multi-head attention over (B, N, H*dh) bf16: fp32
scores times dh^-0.5, an online softmax with fp32 running max and sum, P
rounded to bf16 before the P.V product, fp32 accumulation, bf16 output.

On the H100 the op is tensor-core bound (4*B*H*N^2*dh FLOPs against
3*B*N*H*dh*2 bytes of input): the kernel keeps S and P on chip, runs both
products on the tensor cores with ``mma.sync``, and reads the heads strided
out of (B, N, H*dh) without a split-heads copy. See the source for the tiling.

:func:`flash_attention` launches the kernel for a CUDA tensor and calls the
plain version :func:`flash_attention_ref` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native

BLOCK_K = 64  # the kernel's K/V tile; the plain version walks the same blocks
# head widths padded to the MMA k-step that the kernel is instantiated for:
# ds1's dh = 40 (as 48), ds2's dh = 80, and 16 for small test shapes
PADDED_DH = (16, 48, 80)

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, block for block.

    Walks the keys in ``BLOCK_K`` blocks with the kernel's online softmax, so
    that P is rounded to the input dtype relative to the running max exactly
    where the kernel (and ``_flash_kernel_v5``) rounds it.
    """
    b, n, d = q.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    split = lambda t: t.reshape(b, -1, h, dh).transpose(1, 2).to(torch.float32)
    qh, kh, vh = split(q), split(k), split(v)
    m = torch.full((b, h, n, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, kh.shape[2], BLOCK_K):
        kb = kh[:, :, k0 : k0 + BLOCK_K]
        vb = vh[:, :, k0 : k0 + BLOCK_K]
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).to(torch.float32), vb)
        m = m_new
    out = (acc / l).to(q.dtype)
    return out.transpose(1, 2).reshape(b, n, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention over (B, N, H*dh); the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, num_heads)
    global LAUNCHES
    b, n, d = q.shape
    dh = d // num_heads
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if d % num_heads or dh % 8 or -(-dh // 16) * 16 not in PADDED_DH:
        raise ValueError(f"flash_attention: head width {d}/{num_heads} must be a multiple of 8 "
                         f"that pads to one of {PADDED_DH}")
    fn = _native.function("flash_attention", "vface_flash_attention_bf16", _ARGTYPES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, num_heads, dh,
             float(dh**-0.5), stream)
    _native.check(err, "flash_attention")
    LAUNCHES += 1
    return out
