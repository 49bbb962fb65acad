"""The benchmark reference's model bundle: UNet, VAE, conditioner and DDPM schedule,
float32 (the structure of ``vface_torch/models/ldm.py``; it imports nothing of
the program). The methods take and return NHWC tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from benchmark.reference.conditioning import Conditioner, ConditionerConfig
from benchmark.reference.unet import InjectionSpec, UNetConfig, UNetModel
from benchmark.reference.vae import SD_SCALE_FACTOR, AutoencoderKL, VAEConfig
from benchmark.reference.schedule import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    cond: ConditionerConfig = ConditionerConfig()
    scale_factor: float = SD_SCALE_FACTOR
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    image_size: int = 512  # pixel resolution; the latent is /8 at SD widths

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** (len(self.vae.ch_mult) - 1))


class VFaceModel(nn.Module):
    """UNet + VAE + conditioner + DDPM schedule on one device, float32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.unet = UNetModel(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.conditioner = Conditioner(cfg.cond)
        self.schedule = DiffusionSchedule.create("linear", cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.to(self.device)

    def parts(self) -> dict:
        """The sub-nets by their parameter-group names."""
        return {"unet": self.unet, "vae": self.vae, "cond": self.conditioner}

    def load_params(self, state: dict) -> None:
        """Load ``{"unet": state_dict, "vae": state_dict, "cond": state_dict}``, each strictly."""
        for name, part in self.parts().items():
            part.load_state_dict(state[name])

    # -------------------------------------------------------- first stage
    def encode_first_stage(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) in [-1, 1] -> scaled posterior mode (B, h, w, 4)."""
        return self.vae.encode(img).mode() * self.cfg.scale_factor

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.cfg.scale_factor)

    # -------------------------------------------------------- conditioning
    def _conditioner(self) -> Conditioner:
        if self.conditioner is None:
            raise ValueError("VFaceModel was built without a conditioner (conditioner=True builds it)")
        return self.conditioner

    def conditioning(self, src_clip, landmarks136=None, tar_clip=None, src_face01=None) -> torch.Tensor:
        return self._conditioner()(src_clip, landmarks136, tar_clip, src_face01)

    def uncond(self, batch: int) -> torch.Tensor:
        return self._conditioner().uncond(batch)

    # -------------------------------------------------------------- UNet
    def apply_model(self, x9, t, context, flow=None, injection: Optional[InjectionSpec] = None):
        """epsilon prediction; x9 (B, h, w, 9), t (B,) int, context (B, 1, D)."""
        return self.unet(x9, t, context, flow=flow, injection=injection)
