"""AutoencoderKL, the KL-f8 first stage of Stable Diffusion, PyTorch.

Port of ``vface_tpu/models/vae.py``: encoder (conv_in, levels of ResnetBlocks
with strided downsampling, mid res/attn/res, GroupNorm/SiLU, conv_out to
2*z channels), decoder (mirror with nearest-2x upsampling), the 1x1
``quant_conv``/``post_quant_conv`` and the diagonal Gaussian posterior.
``encode``/``decode`` take and return NHWC; the convs run NCHW inside. Every
GroupNorm here uses eps 1e-6; the big-spatial ones (128^2-512^2) take their
statistics from the GN-stats kernel K3.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.layers import Conv, GroupNorm32, SelfAttention2D, nonlinearity, upsample_nearest_2x

SD_SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    in_channels: int = 3
    out_channels: int = 3
    double_z: bool = True
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls):
        return cls(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.float32)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv(in_ch, out_ch, dtype=dtype)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv(out_ch, out_ch, dtype=dtype)
        self.nin_shortcut = Conv(in_ch, out_ch, kernel=1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 conv after the reference's asymmetric (0, 1) x (0, 1) zero pad."""

    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(ch, ch, stride=2, padding=0, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(ch, ch, dtype=dtype)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        self.cfg = cfg
        self.conv_in = Conv(cfg.in_channels, cfg.ch, dtype=dt)
        ch = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(ch, cfg.ch * mult, dtype=dt))
                ch = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch, dtype=dt))
        self.mid_block_1 = ResnetBlock(ch, ch, dtype=dt)
        self.mid_attn_1 = SelfAttention2D(ch, dtype=dt)
        self.mid_block_2 = ResnetBlock(ch, ch, dtype=dt)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, cfg.z_channels * (2 if cfg.double_z else 1), dtype=dt)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for i in range(len(cfg.ch_mult)):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(cfg.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(nonlinearity(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        self.cfg = cfg
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, ch, dtype=dt)
        self.mid_block_1 = ResnetBlock(ch, ch, dtype=dt)
        self.mid_attn_1 = SelfAttention2D(ch, dtype=dt)
        self.mid_block_2 = ResnetBlock(ch, ch, dtype=dt)
        for i in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(ch, cfg.ch * cfg.ch_mult[i], dtype=dt))
                ch = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(ch, dtype=dt))
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, cfg.out_channels, dtype=dt)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for i in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(nonlinearity(self.norm_out(h)))


class DiagonalGaussian:
    """Posterior N(mean, exp(logvar)) over NHWC moments; logvar clamped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = torch.chunk(moments, 2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator = None) -> torch.Tensor:
        """mean + std * eps, eps standard normal in the moments' dtype from ``generator``."""
        eps = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL divergence from the standard normal, summed per sample: (B,)."""
        return 0.5 * (self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar).sum(dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """KL autoencoder: ``encode`` (NHWC image -> posterior), ``decode`` (NHWC z -> image).

    The LDM-side scale factor is applied by the caller (:mod:`vface_torch.models.ldm`).
    """

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        enc_out = cfg.z_channels * (2 if cfg.double_z else 1)
        moments = 2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim
        self.quant_conv = Conv(enc_out, moments, kernel=1, dtype=cfg.dtype)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, kernel=1, dtype=cfg.dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        h = x.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous()
        moments = self.quant_conv(self.encoder(h))
        return DiagonalGaussian(moments.permute(0, 2, 3, 1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(self.cfg.dtype).permute(0, 3, 1, 2).contiguous()
        return self.decoder(self.post_quant_conv(h)).permute(0, 2, 3, 1)
