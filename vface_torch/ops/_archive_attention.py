"""The archived flash-attention variants (K10-K12), on the port's kernels.

Port of ``vface_tpu/ops/_archive_attention.py``: ``flash_attention_v3`` (K10),
``flash_attention_v4`` (K11) and ``flash_attention_v6`` (K12), with the JAX
signatures less ``interpret``. Like the JAX module it is private: nothing on
the serving or training path calls it; the attention benches
(:mod:`vface_torch.bench.attention`, :mod:`vface_torch.bench.attn_v56`) do.

The three TPU kernels differ from the live ones only in their transposed
(dh, N) layout, which kept dh = 40 off the TPU's 128-lane axis and has no
meaning on the H100. What each computes maps onto a port kernel:

* v3 and v4 cast the operands to fp32 and run an online softmax over
  ``block_k``-key blocks with fp32 P, the output in the input dtype: K8's
  function, on K8's kernels (``flash_attention._launch_k8``): bf16 operands
  on K6's kernel (``csrc/flash_attention.cu``, P as a bf16 hi + lo pair; dh
  32 on the tf32 kernel), fp32 ones on the tf32 kernel
  (``csrc/flash_attention_f32.cu``, 3xTF32 products). The kernels walk their
  own 64-key tiles; the plain version walks the caller's ``block_k`` blocks.
* v6 takes bf16 operands with fp32 scores and rounds P to the operands' dtype
  before P.V: K1's function (``csrc/flash_attention.cu``). On fp32 operands
  the rounding is a no-op and v6 computes v2's function, which the tf32
  kernel computes.

Routing is JAX's: where ``block_q`` or ``block_k`` (capped at N) does not
divide Nq or Nk, :func:`~vface_torch.ops.attention.multi_head_attention`
computes the result, as JAX's XLA path does. Each function counts its
launches under its own key of ``flash_attention.LAUNCHES``. On the card a
call the kernel does not take raises: K1 takes head widths that pad to
``PADDED_DH``, and no variant has a gradient (JAX defines no VJP for them).
"""

from __future__ import annotations

import torch

from vface_torch.ops import flash_attention as FA
from vface_torch.ops._autograd import needs_grad
from vface_torch.ops.attention import multi_head_attention


def _refuse_grad(name: str, q, k, v) -> None:
    if needs_grad(q, k, v):
        raise ValueError(f"{name}: no gradient (the JAX package defines no VJP for it)")


def _k8(name: str, q, k, v, num_heads: int, block_k: int) -> torch.Tensor:
    """K8's function: K8's kernels on CUDA, ``flash_attention_v1_ref`` over
    ``block_k``-key blocks on the CPU."""
    if q.device.type == "cpu":
        return FA.flash_attention_v1_ref(q, k, v, num_heads, block_k=block_k)
    _refuse_grad(name, q, k, v)
    out = torch.empty_like(q)
    FA._launch_k8(name, q, k, v, num_heads, out)
    return out


def flash_attention_v3(q, k, v, num_heads: int, block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """K10: (B, Nq, D) attention over (B, Nk, D), computed in fp32, output in q's dtype."""
    if not FA._tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    return _k8("flash_attention_v3", q, k, v, num_heads, block_k)


def flash_attention_v4(q, k, v, num_heads: int, block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """K11: v3's function (the TPU kernel's grid walks the key blocks instead)."""
    if not FA._tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    return _k8("flash_attention_v4", q, k, v, num_heads, block_k)


def flash_attention_v6(q, k, v, num_heads: int, block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """K12: bf16 operands, fp32 scores, P rounded to bf16 before P.V: K1's
    kernel on the card, K1's plain version on the CPU. fp32 operands: v2's
    function, the tf32 kernel (plain: over ``block_k``-key blocks)."""
    if not FA._tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    if q.dtype == torch.float32:
        return _k8("flash_attention_v6", q, k, v, num_heads, block_k)
    if q.device.type == "cpu":
        return FA.flash_attention_ref(q, k, v, num_heads)
    _refuse_grad("flash_attention_v6", q, k, v)
    out = torch.empty_like(q)
    FA._launch_fwd("flash_attention_v6", q, k, v, num_heads, (out,))
    return out
