"""VFaceModel: the latent-diffusion face-swap bundle (UNet, VAE, conditioner, schedule), PyTorch.

Port of ``vface_tpu/models/ldm.py``. The modules own their parameters (load
them with :func:`vface_torch.utils.convert.from_flax_params` or
:func:`~vface_torch.utils.convert.init_params`); every parameter is
differentiable, and :func:`vface_torch.pipelines.train.trainable_mask` picks
the set that training updates. The methods take and return NHWC tensors like
the JAX bundle's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from vface_torch.models.conditioning import Conditioner, ConditionerConfig
from vface_torch.models.unet import InjectionSpec, UNetConfig, UNetModel
from vface_torch.models.vae import SD_SCALE_FACTOR, AutoencoderKL, VAEConfig
from vface_torch.utils.platform import resolve_device
from vface_torch.utils.schedule import DiffusionSchedule


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

    @classmethod
    def sd_v1_inpaint(cls, dtype=torch.bfloat16):
        return cls(unet=UNetConfig.sd_v1_inpaint(dtype=dtype),
                   vae=dataclasses.replace(VAEConfig(), dtype=dtype))

    @classmethod
    def tiny(cls, image_size: int = 32):
        return cls(unet=UNetConfig.tiny(), vae=VAEConfig.tiny(), cond=ConditionerConfig.tiny(),
                   image_size=image_size)

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** (len(self.vae.ch_mult) - 1))


class VFaceModel(nn.Module):
    """UNet + VAE (+ conditioner) + DDPM schedule on one device (CUDA unless ``device="cpu"``).

    ``conditioner=True`` builds the conditioner (CLIP ViT, ArcFace and the
    conditioning heads), which training needs; serving takes its embeddings as
    inputs and leaves it out.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda", conditioner: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unet = UNetModel(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.conditioner = Conditioner(cfg.cond) if conditioner else None
        self.schedule = DiffusionSchedule.create("linear", cfg.timesteps, cfg.linear_start, cfg.linear_end)
        self.to(self.device)

    def load_params(self, state: dict) -> None:
        """Load ``{"unet": state_dict, "vae": state_dict[, "cond": state_dict]}``, each
        strictly; "cond" is required with a conditioner and ignored without one."""
        self.unet.load_state_dict(state["unet"])
        self.vae.load_state_dict(state["vae"])
        if self.conditioner is not None:
            self.conditioner.load_state_dict(state["cond"])

    # -------------------------------------------------------- first stage
    def encode_first_stage(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) in [-1, 1] -> scaled posterior mode (B, h, w, 4)."""
        return self.vae.encode(img).mode() * self.cfg.scale_factor

    def encode_first_stage_sample(self, img: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Scaled posterior sample, the draw from ``generator`` (training's latents)."""
        return self.vae.encode(img).sample(generator) * self.cfg.scale_factor

    def encode_first_stage_given_eps(self, img: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Scaled posterior sample with a supplied standard-normal draw ``eps``."""
        post = self.vae.encode(img)
        return (post.mean + post.std * eps) * self.cfg.scale_factor

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
    def build_unet_input(self, z, z_inpaint, mask_latent) -> torch.Tensor:
        """concat([z, z_inpaint, mask]) -> 9 channels."""
        return torch.cat([z, z_inpaint, mask_latent], dim=-1)

    def apply_model(self, x9, t, context, flow=None, injection: Optional[InjectionSpec] = None):
        """epsilon prediction; x9 (B, h, w, 9), t (B,) int, context (B, 1, D)."""
        return self.unet(x9, t, context, flow=flow, injection=injection)

    # ----------------------------------------------------------- schedule
    def _table(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(getattr(self.schedule, name), device=t.device)[t][:, None, None, None]

    def q_sample(self, z0, t, noise) -> torch.Tensor:
        return self._table("sqrt_alphas_cumprod", t) * z0 + self._table("sqrt_one_minus_alphas_cumprod", t) * noise

    def predict_start_from_noise(self, z_t, t, noise) -> torch.Tensor:
        return (self._table("sqrt_recip_alphas_cumprod", t) * z_t
                - self._table("sqrt_recipm1_alphas_cumprod", t) * noise)
