"""SD-v1 UNet (9-channel inpainting variant) with first-class injection, PyTorch.

Port of ``vface_tpu/models/unet.py``: the same topology, parameter names and
numerics (params float32, compute in ``cfg.dtype``, normalisations in
float32). The public ``UNetModel.forward`` takes and returns NHWC like the JAX
module; activations run NCHW inside.

Self-attention sites route by token count: N >= 512 (ds1, N = 4096, dh = 40
and ds2, N = 1024, dh = 80 at 512^2) go to the flash-attention kernels (K1
without a gradient; K4 forward, K6 and K5 backward with one); smaller sites
(ds4) to :func:`multi_head_attention`. The transformer feed-forward goes to
the fused GEGLU kernel K2 at C <= 768 when ``use_fused_ff``.

``use_remat`` checkpoints every ResBlock and SpatialTransformer, as the JAX
module's ``nn.remat`` does (``torch.utils.checkpoint``, non-reentrant): their
activations are recomputed in the backward, so each attention site runs its
forward twice per backward pass. It acts only where a gradient is being
recorded.

Not ported yet: the encoder cache, ``return_features``, the TSG conv
injection, the dual 2x768 context and ``EncoderUNetModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vface_torch.models.layers import (
    Conv, Dense, GroupNorm32, LayerNormF32, nonlinearity, upsample_nearest_2x,
)
from vface_torch.ops.attention import FlowPack, FusionConfig, fuse_qkv, multi_head_attention
from vface_torch.ops.flash_attention import flash_attention
from vface_torch.ops.geglu_ff import MAX_C as GEGLU_MAX_C, geglu_ff, geglu_ff_ref
from vface_torch.utils.schedule import timestep_embedding

NONE = FusionConfig("none")
FLASH_MIN_TOKENS = 512


@dataclasses.dataclass(frozen=True)
class InjectionSpec:
    """Static per-site-class fusion spec: input blocks / middle / output blocks."""

    input_blocks: FusionConfig = NONE
    middle: FusionConfig = NONE
    output_blocks: FusionConfig = NONE
    chunks: int = 3

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
    use_remat: bool = True  # checkpoint ResBlocks and SpatialTransformers when training
    use_flash: bool = False  # flash-attention kernel at self-attention sites with N >= 512
    use_fused_ff: bool = False  # fused GEGLU kernel at C <= 768
    dtype: torch.dtype = torch.float32

    @classmethod
    def sd_v1_inpaint(cls, dtype=torch.bfloat16, use_flash: bool = True):
        return cls(dtype=dtype, use_flash=use_flash, use_fused_ff=True)

    @classmethod
    def tiny(cls):
        """Unit-test config: same topology, tiny widths."""
        return cls(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), num_heads=4,
                   context_dim=64, use_remat=False)


class CrossAttention(nn.Module):
    """q from x, k/v from the context (or x for self-attention); attn1 is fusion-aware."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dtype=torch.float32, use_flash: bool = False):
        super().__init__()
        kv_dim = context_dim or query_dim
        self.heads = heads
        self.dtype = dtype
        self.use_flash = use_flash
        self.to_q = Dense(query_dim, query_dim, bias=False, dtype=dtype)
        self.to_k = Dense(kv_dim, query_dim, bias=False, dtype=dtype)
        self.to_v = Dense(kv_dim, query_dim, bias=False, dtype=dtype)
        self.to_out = Dense(query_dim, query_dim, dtype=dtype)

    def forward(self, x, context=None, fusion: FusionConfig = NONE, chunks: int = 3, flow=None):
        ctx = x if context is None else context
        if context is not None and ctx.shape[1] == 1 and not fusion.active:
            # single-token context: the softmax over one key is exactly 1, so
            # every query's output is v; project it once and broadcast
            out = self.to_out(self.to_v(ctx))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if fusion.active:
            if isinstance(flow, FlowPack):
                flow_arr, pair_mask = flow.flow, flow.pair_mask
            else:
                flow_arr, pair_mask = flow, None
            q, k, v = fuse_qkv(q, k, v, fusion, chunks=chunks, flow=flow_arr, pair_mask=pair_mask)
            q, k, v = q.to(self.dtype), k.to(self.dtype), v.to(self.dtype)
        if self.use_flash and context is None and x.shape[1] >= FLASH_MIN_TOKENS:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), self.heads)
        else:
            out = multi_head_attention(q, k, v, self.heads, dtype=self.dtype)
        return self.to_out(out)


class GEGLU(nn.Module):
    """Parameter holder for the GEGLU projection (``geglu.proj``: C -> 2I)."""

    def __init__(self, dim: int, inner: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim, 2 * inner, dtype=dtype)


class FeedForward(nn.Module):
    """``proj_out(a * gelu_erf(gate))`` with ``[a | gate] = geglu.proj(x)``."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, use_fused: bool = False):
        super().__init__()
        inner = dim * mult
        self.dtype = dtype
        self.use_fused = use_fused and dim <= GEGLU_MAX_C
        self.geglu = GEGLU(dim, inner, dtype=dtype)
        self.proj_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        dt = self.dtype
        fn = geglu_ff if self.use_fused else geglu_ff_ref
        return fn(x.to(dt).contiguous(), self.geglu.proj.weight.to(dt), self.geglu.proj.bias.to(dt),
                  self.proj_out.weight.to(dt), self.proj_out.bias.to(dt))


class BasicTransformerBlock(nn.Module):
    """attn1 (self, injection site) -> attn2 (cross to conditioning) -> FF."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype=torch.float32,
                 use_flash: bool = False, use_fused_ff: bool = False):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, heads=heads, dtype=dtype, use_flash=use_flash)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads, dtype=dtype)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim, dtype=dtype, use_fused=use_fused_ff)

    def forward(self, x, context, fusion: FusionConfig, chunks: int, flow):
        x = x + self.attn1(self.norm1(x), None, fusion=fusion, chunks=chunks, flow=flow)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj_in -> transformer blocks over HW tokens -> 1x1 proj_out + residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, depth: int = 1,
                 dtype=torch.float32, use_flash: bool = False, use_fused_ff: bool = False):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv(channels, channels, kernel=1, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                channels, context_dim, heads, dtype=dtype, use_flash=use_flash,
                use_fused_ff=use_fused_ff))
        self.depth = depth
        self.proj_out = Conv(channels, channels, kernel=1, zero_init=True, dtype=dtype)

    def forward(self, x, context, fusion: FusionConfig, chunks: int, flow):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.reshape(b, c, h * w).transpose(1, 2)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context, fusion, chunks, flow)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(x) + res


class ResBlock(nn.Module):
    """UNet residual block with the timestep-embedding add."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dtype=torch.float32):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = Conv(in_ch, out_ch, dtype=dtype)
        self.emb_proj = Dense(emb_dim, out_ch, dtype=dtype)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = Conv(out_ch, out_ch, zero_init=True, dtype=dtype)
        self.skip = Conv(in_ch, out_ch, kernel=1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(nonlinearity(self.in_norm(x)))
        h = h + self.emb_proj(nonlinearity(emb))[:, :, None, None]
        h = self.out_conv(nonlinearity(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.op = Conv(ch, ch, stride=2, dtype=dtype)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(ch, ch, dtype=dtype)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class UNetModel(nn.Module):
    """The 9-channel SD UNet. ``forward(x (B, H, W, 9), t (B,), context (B, T, D))``
    returns the float32 epsilon prediction (B, H, W, 4).

    ``injection`` selects the fusion per site class; ``flow`` is the FGATS
    pixel flow (F-1, Hq, Wq, 2) at the ds1 token grid, or a :class:`FlowPack`.
    """

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed_0 = Dense(mc, emb_dim, dtype=dt)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dt)
        self.conv_in = Conv(cfg.in_channels, mc, dtype=dt)

        def attn(name, ch):
            self.add_module(name, SpatialTransformer(
                ch, cfg.context_dim, cfg.num_heads, cfg.transformer_depth, dtype=dt,
                use_flash=cfg.use_flash, use_fused_ff=cfg.use_fused_ff))

        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"in_{level}_{i}_res", ResBlock(ch, mc * mult, emb_dim, dtype=dt))
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    attn(f"in_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"in_{level}_down", Downsample(ch, dtype=dt))
                chans.append(ch)
                ds *= 2
        self.mid_res_0 = ResBlock(ch, ch, emb_dim, dtype=dt)
        attn("mid_attn", ch)
        self.mid_res_1 = ResBlock(ch, ch, emb_dim, dtype=dt)
        for level in reversed(range(len(cfg.channel_mult))):
            out_ch = mc * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"out_{level}_{i}_res", ResBlock(ch + chans.pop(), out_ch, emb_dim, dtype=dt))
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    attn(f"out_{level}_{i}_attn", ch)
                if level != 0 and i == cfg.num_res_blocks:
                    self.add_module(f"out_{level}_up", Upsample(ch, dtype=dt))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv(ch, cfg.out_channels, zero_init=True, dtype=dt)

    def forward(self, x, timesteps, context, flow=None, injection: Optional[InjectionSpec] = None):
        cfg = self.cfg
        inj = injection or InjectionSpec()
        dt = cfg.dtype
        m = lambda name: getattr(self, name)
        x = x.to(dt).permute(0, 3, 1, 2)
        context = context.to(dt)
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels).to(dt))
        emb = self.time_embed_2(nonlinearity(emb))

        remat = cfg.use_remat and torch.is_grad_enabled()

        def block(name, *args):
            if remat:
                return checkpoint(m(name), *args, use_reentrant=False)
            return m(name)(*args)

        def attn(h, site, name):
            return block(name, h, context, inj.for_site(site), inj.chunks, flow)

        hs = []
        h = self.conv_in(x)
        hs.append(h)
        ds = 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = block(f"in_{level}_{i}_res", h, emb)
                if ds in cfg.attention_resolutions:
                    h = attn(h, "in", f"in_{level}_{i}_attn")
                hs.append(h)
            if level != len(cfg.channel_mult) - 1:
                h = m(f"in_{level}_down")(h)
                hs.append(h)
                ds *= 2
        h = block("mid_res_0", h, emb)
        h = attn(h, "mid", "mid_attn")
        h = block("mid_res_1", h, emb)
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = block(f"out_{level}_{i}_res", torch.cat([h, hs.pop()], dim=1), emb)
                if ds in cfg.attention_resolutions:
                    h = attn(h, "out", f"out_{level}_{i}_attn")
                if level != 0 and i == cfg.num_res_blocks:
                    h = m(f"out_{level}_up")(h)
                    ds //= 2
        h = nonlinearity(self.out_norm(h))
        out = self.out_conv(h).to(torch.float32)
        return out.permute(0, 2, 3, 1)
