"""VFaceModel: the latent-diffusion face-swap bundle (UNet, VAE, schedule), PyTorch.

Port of ``vface_tpu/models/ldm.py`` without the conditioner: the swap core
takes its conditioning embeddings precomputed. The modules own their
parameters (load them with :func:`vface_torch.utils.convert.from_flax_params`
or :func:`~vface_torch.utils.convert.init_params`); the methods take and
return NHWC tensors like the JAX bundle's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from vface_torch.models.unet import InjectionSpec, UNetConfig, UNetModel
from vface_torch.models.vae import SD_SCALE_FACTOR, AutoencoderKL, VAEConfig
from vface_torch.utils.platform import resolve_device
from vface_torch.utils.schedule import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    scale_factor: float = SD_SCALE_FACTOR
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    image_size: int = 512  # pixel resolution; the latent is /8 at SD widths

    @classmethod
    def sd_v1_inpaint(cls, dtype=torch.bfloat16):
        return cls(unet=UNetConfig.sd_v1_inpaint(dtype=dtype),
                   vae=dataclasses.replace(VAEConfig(), dtype=dtype))

    @classmethod
    def tiny(cls, image_size: int = 32):
        return cls(unet=UNetConfig.tiny(), vae=VAEConfig.tiny(), image_size=image_size)

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** (len(self.vae.ch_mult) - 1))


class VFaceModel(nn.Module):
    """UNet + VAE + DDPM schedule on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unet = UNetModel(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.schedule = DiffusionSchedule.create("linear", cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.requires_grad_(False)
        self.to(self.device)

    def load_params(self, state: dict) -> None:
        """Load ``{"unet": state_dict, "vae": state_dict}`` (strictly)."""
        self.unet.load_state_dict(state["unet"])
        self.vae.load_state_dict(state["vae"])

    # -------------------------------------------------------- first stage
    def encode_first_stage(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) in [-1, 1] -> scaled posterior mode (B, h, w, 4)."""
        return self.vae.encode(img).mode() * self.cfg.scale_factor

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.cfg.scale_factor)

    # -------------------------------------------------------------- UNet
    def apply_model(self, x9, t, context, flow=None, injection: Optional[InjectionSpec] = None):
        """epsilon prediction; x9 (B, h, w, 9), t (B,) int, context (B, 1, D)."""
        return self.unet(x9, t, context, flow=flow, injection=injection)

    # ----------------------------------------------------------- schedule
    def q_sample(self, z0, t, noise) -> torch.Tensor:
        s = self.schedule
        a = torch.as_tensor(s.sqrt_alphas_cumprod, device=z0.device)[t][:, None, None, None]
        b = torch.as_tensor(s.sqrt_one_minus_alphas_cumprod, device=z0.device)[t][:, None, None, None]
        return a * z0 + b * noise
