"""Shared building blocks of the port's models (PyTorch, NCHW inside).

Port of ``vface_tpu/models/layers.py``. Conventions:

* activations are NCHW inside the models (the JAX package is NHWC; the
  models' public functions convert at their boundary);
* parameters are float32 and cast to the module's compute ``dtype`` at use;
* normalisations reduce and apply in float32 and cast the result back.

Parameter names mirror the Flax tree with its wrapper levels dropped
(``in_norm/GroupNorm_0/scale`` is ``in_norm.weight``, ``emb_proj/Dense_0/kernel``
is ``emb_proj.weight``), which is what :mod:`vface_torch.utils.convert` walks.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.ops.gn_sums import gn_sums


def nonlinearity(x: torch.Tensor) -> torch.Tensor:
    """SiLU / swish."""
    return F.silu(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW x."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def gn_kernel_eligible(x: torch.Tensor) -> bool:
    """Where the JAX package routes GroupNorm statistics to its Pallas kernel,
    less the TPU-only clauses: big-spatial activations (the VAE's 128^2-512^2
    stages)."""
    if x.ndim != 4:
        return False
    b, c, h, w = x.shape
    return h * w >= (1 << 14) and b * c * h * w >= (1 << 21)


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics (fast variance E[x^2] - E[x]^2).

    The apply is ``y = x32 * a_c + b_c`` in float32 with per-(b, c)
    ``a = inv_std * scale`` and ``b = bias - mean * a``, then the cast back to
    the input dtype. The sums come from the GN-stats kernel where
    :func:`gn_kernel_eligible`, else from a plain float32 reduction.
    """

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__()
        self.eps = eps
        self.num_groups = min(num_groups, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        cg = c // g
        x32 = x.to(torch.float32)
        if gn_kernel_eligible(x):
            s1, s2 = gn_sums(x.contiguous())
        else:
            dims = tuple(range(2, x.ndim))
            s1, s2 = x32.sum(dim=dims), (x32 * x32).sum(dim=dims)
        count = cg * math.prod(x.shape[2:])
        g1 = s1.reshape(b, g, cg).sum(dim=-1) / count
        g2 = s2.reshape(b, g, cg).sum(dim=-1) / count
        inv = torch.rsqrt(g2 - g1 * g1 + self.eps)
        mean_c = g1[..., None].expand(b, g, cg).reshape(b, c)
        inv_c = inv[..., None].expand(b, g, cg).reshape(b, c)
        a_c = inv_c * self.weight.to(torch.float32)[None]
        b_c = self.bias.to(torch.float32)[None] - mean_c * a_c
        shape = (b, c) + (1,) * (x.ndim - 2)
        return (x32 * a_c.reshape(shape) + b_c.reshape(shape)).to(x.dtype)


class LayerNormF32(nn.Module):
    """LayerNorm over the last dim, reducing and applying in float32 (eps 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mu = x32.mean(dim=-1, keepdim=True)
        m2 = (x32 * x32).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(m2 - mu * mu + self.eps)
        y = (x32 - mu) * inv * self.weight.to(torch.float32) + self.bias.to(torch.float32)
        return y.to(x.dtype)


class Conv(nn.Module):
    """k x k convolution on NCHW with float32 params cast to ``dtype`` at use.

    ``padding="torch"`` is the symmetric (k-1)//2 on both sides, as
    ``torch.nn.Conv2d(padding=k//2)``; an int pads that much on every side.
    ``zero_init`` marks the convs the reference zero-initialises (for
    :func:`vface_torch.utils.convert.init_params`); ``bias=False`` is a
    bias-free conv (the CLIP patch embedding, ArcFace).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding="torch", zero_init: bool = False, dtype=torch.float32, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2 if padding == "torch" else int(padding)
        self.zero_init = zero_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


class Dense(nn.Module):
    """Linear layer with float32 params cast to ``dtype`` at use; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class SelfAttention2D(nn.Module):
    """Single-head self-attention over H*W (the VAE's mid-block AttnBlock).

    Scores are float32 products of ``dtype`` operands, the softmax runs in
    float32 and its probabilities are rounded to ``dtype`` before the P.V
    product.
    """

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv(channels, channels, kernel=1, dtype=dtype)
        self.k = Conv(channels, channels, kernel=1, dtype=dtype)
        self.v = Conv(channels, channels, kernel=1, dtype=dtype)
        self.proj_out = Conv(channels, channels, kernel=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.norm(x)
        tok = lambda t: t.reshape(b, c, h * w).transpose(1, 2).to(torch.float32)
        q, k, v = tok(self.q(hidden)), tok(self.k(hidden)), tok(self.v(hidden))
        sim = torch.matmul(q, k.transpose(1, 2))
        attn = torch.softmax(sim * (c**-0.5), dim=-1).to(self.dtype).to(torch.float32)
        out = torch.matmul(attn, v).to(self.dtype)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)
