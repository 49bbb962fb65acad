"""First-stage (VAE) training: reconstruction, KL and PatchGAN losses, PyTorch.

Port of ``vface_tpu/pipelines/vae_train.py`` (the reference's
``ldm/modules/losses`` LPIPSWithDiscriminator lineage):

* the generator loss: L1 reconstruction (+ LPIPS through ``perceptual_fn``),
  ``kl_weight`` times the posterior's KL (``mean(kl) / B``, as the JAX
  package computes it), and from ``disc_start`` on ``disc_weight`` times the
  PatchGAN's ``-mean(logits)`` on the reconstruction;
* the discriminator's hinge loss on real images and the detached reconstruction;
* :func:`make_vae_train_step`: one G step, then one D step, each with its own
  torch optimizer.

The posterior is sampled from a ``torch.Generator`` or, for tests, with a
given standard-normal ``eps``. Parameter names mirror the Flax modules'.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.layers import Conv, GroupNorm32


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN (taming's NLayerDiscriminator: 3 layers, ndf 64), NHWC in,
    NHWC logits out; float32 params and compute, GroupNorm eps 1e-6."""

    def __init__(self, ndf: int = 64, layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.layers = layers
        self.conv0 = Conv(in_channels, ndf, kernel=4, stride=2, padding=1)
        ch = ndf
        for i in range(1, layers):
            out = min(ndf * 2**i, ndf * 8)
            self.add_module(f"conv{i}", Conv(ch, out, kernel=4, stride=2, padding=1, bias=False))
            self.add_module(f"norm{i}", GroupNorm32(out, eps=1e-6, num_groups=min(32, out)))
            ch = out
        out = min(ndf * 2**layers, ndf * 8)
        self.conv_pre = Conv(ch, out, kernel=4, padding=1, bias=False)
        self.norm_pre = GroupNorm32(out, eps=1e-6, num_groups=min(32, out))
        self.conv_out = Conv(out, 1, kernel=4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x.to(torch.float32).permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.layers):
            h = F.leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h)), 0.2)
        h = F.leaky_relu(self.norm_pre(self.conv_pre(h)), 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.relu(1.0 - logits_real).mean() + torch.relu(1.0 + logits_fake).mean())


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    kl_weight: float = 1e-6
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 50_001  # taming's default warm-up


def vae_losses(vae, disc: Optional[nn.Module], batch_img: torch.Tensor, step: int,
               cfg: VAELossConfig = VAELossConfig(), perceptual_fn: Optional[Callable] = None,
               generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
    """The generator-side loss of ``vae`` (an :class:`~vface_torch.models.vae.AutoencoderKL`)
    on ``batch_img`` (B, H, W, 3) in [-1, 1]; returns ``(loss, (rec, logs))``.
    The posterior sample draws from ``generator``, or uses ``eps``."""
    post = vae.encode(batch_img)
    z = post.mean + post.std * eps if eps is not None else post.sample(generator)
    rec = vae.decode(z).to(torch.float32)
    rec_loss = (batch_img - rec).abs().mean()
    if perceptual_fn is not None:
        rec_loss = rec_loss + cfg.perceptual_weight * perceptual_fn(rec, batch_img).mean()
    kl = post.kl().to(torch.float32).mean() / batch_img.shape[0]
    loss = rec_loss + cfg.kl_weight * kl
    logs = {"vae/rec": rec_loss, "vae/kl": kl}
    if disc is not None:
        g_loss = -disc(rec).mean()
        loss = loss + (cfg.disc_weight if step >= cfg.disc_start else 0.0) * g_loss
        logs["vae/g"] = g_loss
    logs["vae/loss"] = loss
    return loss, (rec, logs)


def discriminator_loss(disc: nn.Module, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return hinge_d_loss(disc(real), disc(fake.detach()))


def make_vae_train_step(vae, disc: nn.Module, g_opt, d_opt, cfg: VAELossConfig = VAELossConfig(),
                        perceptual_fn: Optional[Callable] = None):
    """Returns ``step(img, step, generator=None, eps=None) -> logs``: one update of
    the VAE by ``g_opt`` on :func:`vae_losses` (the discriminator frozen for
    it), then one of ``disc`` by ``d_opt`` on :func:`discriminator_loss`
    against that step's reconstruction. Logs are detached tensors."""

    def train_step(img: torch.Tensor, step: int, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> dict:
        g_opt.zero_grad(set_to_none=True)
        disc.requires_grad_(False)
        loss, (rec, logs) = vae_losses(vae, disc, img, step, cfg, perceptual_fn, generator, eps)
        loss.backward()
        g_opt.step()
        disc.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = discriminator_loss(disc, img, rec)
        d_loss.backward()
        d_opt.step()
        logs["vae/d"] = d_loss
        return {k: v.detach() for k, v in logs.items()}

    return train_step
