"""The benchmark reference's SD-v1 UNet (9-channel inpainting), plain float32.

The topology and parameter names of ``vface_torch/models/unet.py`` (NHWC at
``forward``'s boundary, NCHW inside), on the path the cells run: every
self-attention site runs :func:`multi_head_attention`, every feed-forward
the plain GEGLU, and the attn1 sites of the block classes that an
:class:`InjectionSpec` names take the FSAI / FGATS fusion. It imports nothing
of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from benchmark.reference.attention import FusionConfig, fuse_qkv, multi_head_attention
from benchmark.reference.layers import Conv, Dense, GroupNorm32, LayerNormF32, nonlinearity, upsample_nearest_2x
from benchmark.reference.schedule import timestep_embedding

NONE = FusionConfig("none")


@dataclasses.dataclass(frozen=True)
class InjectionSpec:
    """The fusion of each site class (input blocks, middle, output blocks) and
    the number of chunks the batch holds."""

    input_blocks: FusionConfig = NONE
    middle: FusionConfig = NONE
    output_blocks: FusionConfig = NONE
    chunks: int = 2

    def for_site(self, site: str) -> FusionConfig:
        return {"in": self.input_blocks, "mid": self.middle, "out": self.output_blocks}[site]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (1, 2, 4)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dtype: torch.dtype = torch.float32


class CrossAttention(nn.Module):
    """q from x, k and v from the context (x itself for self-attention)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8):
        super().__init__()
        kv_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = Dense(query_dim, query_dim, bias=False)
        self.to_k = Dense(kv_dim, query_dim, bias=False)
        self.to_v = Dense(kv_dim, query_dim, bias=False)
        self.to_out = Dense(query_dim, query_dim)

    def forward(self, x, context=None, fusion: FusionConfig = NONE, chunks: int = 2, flow=None):
        ctx = x if context is None else context
        if context is not None and ctx.shape[1] == 1:
            # one key: its softmax weight is exactly 1, so every query's output is its value
            out = self.to_out(self.to_v(ctx))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        q, k, v = fuse_qkv(q, k, v, fusion, chunks, flow)
        return self.to_out(multi_head_attention(q, k, v, self.heads))


class GEGLU(nn.Module):
    """Parameter holder for the GEGLU projection (``geglu.proj``: C -> 2I)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Dense(dim, 2 * inner)


class FeedForward(nn.Module):
    """``proj_out(a * gelu(gate))`` with ``[a | gate] = geglu.proj(x)`` (the erf GELU)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.inner = dim * mult
        self.geglu = GEGLU(dim, self.inner)
        self.proj_out = Dense(self.inner, dim)

    def forward(self, x):
        h = self.geglu.proj(x)
        return self.proj_out(h[..., :self.inner] * torch.nn.functional.gelu(h[..., self.inner:]))


class BasicTransformerBlock(nn.Module):
    """attn1 (self, the fusion site) -> attn2 (cross, to the conditioning) -> FF."""

    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, heads=heads)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, fusion: FusionConfig, chunks: int, flow):
        x = x + self.attn1(self.norm1(x), None, fusion, chunks, flow)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj_in -> transformer blocks over HW tokens -> 1x1 proj_out + residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv(channels, channels, kernel=1)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(channels, context_dim, heads))
        self.depth = depth
        self.proj_out = Conv(channels, channels, kernel=1)

    def forward(self, x, context, fusion: FusionConfig, chunks: int, flow):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x)).reshape(b, c, h * w).transpose(1, 2)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context, fusion, chunks, flow)
        return self.proj_out(x.transpose(1, 2).reshape(b, c, h, w)) + res


class ResBlock(nn.Module):
    """UNet residual block with the timestep-embedding add."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = Conv(in_ch, out_ch)
        self.emb_proj = Dense(emb_dim, out_ch)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = Conv(out_ch, out_ch)
        self.skip = Conv(in_ch, out_ch, kernel=1) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(nonlinearity(self.in_norm(x)))
        h = h + self.emb_proj(nonlinearity(emb))[:, :, None, None]
        h = self.out_conv(nonlinearity(self.out_norm(h)))
        return (x if self.skip is None else self.skip(x)) + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv(ch, ch, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class UNetModel(nn.Module):
    """The 9-channel SD UNet: ``forward(x (B, H, W, 9), t (B,), context (B, T, D))``
    -> epsilon (B, H, W, 4); ``flow`` is the FGATS flow (F-1, Hq, Wq, 2) at the
    ds1 token grid."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed_0 = Dense(mc, emb_dim)
        self.time_embed_2 = Dense(emb_dim, emb_dim)
        self.conv_in = Conv(cfg.in_channels, mc)

        def attn(name, ch):
            self.add_module(name, SpatialTransformer(ch, cfg.context_dim, cfg.num_heads, cfg.transformer_depth))

        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"in_{level}_{i}_res", ResBlock(ch, mc * mult, emb_dim))
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    attn(f"in_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"in_{level}_down", Downsample(ch))
                chans.append(ch)
                ds *= 2
        self.mid_res_0 = ResBlock(ch, ch, emb_dim)
        attn("mid_attn", ch)
        self.mid_res_1 = ResBlock(ch, ch, emb_dim)
        for level in reversed(range(len(cfg.channel_mult))):
            out_ch = mc * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"out_{level}_{i}_res", ResBlock(ch + chans.pop(), out_ch, emb_dim))
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    attn(f"out_{level}_{i}_attn", ch)
                if level != 0 and i == cfg.num_res_blocks:
                    self.add_module(f"out_{level}_up", Upsample(ch))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv(ch, cfg.out_channels)

    def forward(self, x, timesteps, context, flow=None, injection: Optional[InjectionSpec] = None):
        cfg, inj = self.cfg, injection or InjectionSpec()
        m = lambda name: getattr(self, name)
        emb = self.time_embed_2(nonlinearity(self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels))))
        attn = lambda h, site, name: m(name)(h, context, inj.for_site(site), inj.chunks, flow)
        levels = len(cfg.channel_mult)
        h = self.conv_in(x.permute(0, 3, 1, 2))
        hs, ds = [h], 1
        for level in range(levels):
            for i in range(cfg.num_res_blocks):
                h = m(f"in_{level}_{i}_res")(h, emb)
                if ds in cfg.attention_resolutions:
                    h = attn(h, "in", f"in_{level}_{i}_attn")
                hs.append(h)
            if level != levels - 1:
                h = m(f"in_{level}_down")(h)
                hs.append(h)
                ds *= 2
        h = self.mid_res_1(attn(self.mid_res_0(h, emb), "mid", "mid_attn"), emb)
        for level in reversed(range(levels)):
            for i in range(cfg.num_res_blocks + 1):
                h = m(f"out_{level}_{i}_res")(torch.cat([h, hs.pop()], dim=1), emb)
                if ds in cfg.attention_resolutions:
                    h = attn(h, "out", f"out_{level}_{i}_attn")
                if level != 0 and i == cfg.num_res_blocks:
                    h = m(f"out_{level}_up")(h)
                    ds //= 2
        return self.out_conv(nonlinearity(self.out_norm(h))).permute(0, 2, 3, 1)
