"""The reference's model configuration from a configuration file's sizes, in float32."""

from __future__ import annotations

import torch

from benchmark.reference.clip import CLIPVisionConfig
from benchmark.reference.conditioning import ConditionerConfig
from benchmark.reference.ldm import ModelConfig
from benchmark.reference.unet import UNetConfig
from benchmark.reference.vae import VAEConfig

_F32 = {"dtype": torch.float32}


def _sizes(group: dict, drop=("dtype",)) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items() if k not in drop}


def model_config(cfg: dict) -> ModelConfig:
    """``cfg``: a configuration file's JSON object; every compute dtype float32."""
    cond = _sizes(cfg["cond"], drop=("clip",))
    cond["arcface_stages"] = tuple(tuple(s) for s in cfg["cond"]["arcface_stages"])
    return ModelConfig(
        unet=UNetConfig(**_sizes(cfg["unet"]), **_F32),
        vae=VAEConfig(**_sizes(cfg["vae"]), **_F32),
        cond=ConditionerConfig(clip=CLIPVisionConfig(**_sizes(cfg["cond"]["clip"]), **_F32), **cond),
        scale_factor=cfg["scale_factor"], timesteps=cfg["timesteps"], linear_start=cfg["linear_start"],
        linear_end=cfg["linear_end"], image_size=cfg["image_size"])
