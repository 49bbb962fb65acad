"""The REFace conditioning token builder, PyTorch.

Port of ``vface_tpu/models/conditioning.py`` in the shipped "sum" mode:

    c_clip = proj_out_source(CLIP(src)) [+ proj_out_target(CLIP(tar))]
    c_id   = id_proj_out(l2norm(ArcFace(src_face)))       # (B, 1, D)
    c_lm   = landmark_proj_out(landmarks_136)             # (B, 1, D)
    c      = (w_clip*c_clip + w_id*c_id + w_lm*c_lm) / (w_clip + w_id + w_lm)

plus the learnable unconditional vector for CFG and condition dropout. The
"concat", "stack" and "sep_head" token modes are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from vface_torch.models.arcface import IR_50_STAGES, IRSE50, arcface_preprocess, safe_l2_normalize
from vface_torch.models.clip import CLIPConditioner, CLIPVisionConfig
from vface_torch.models.layers import Dense

LANDMARK_DIM = 136


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    clip: CLIPVisionConfig = CLIPVisionConfig()
    clip_weight: float = 1.0
    id_weight: float = 10.0
    landmarks_weight: float = 0.05
    landmark_cond: bool = True
    source_clip_feat: bool = True
    target_clip_feat: bool = True
    # the reference divides by the summed weights when the key is absent
    weight_division: bool = True
    context_dim: int = 768
    arcface_stages: tuple = IR_50_STAGES
    mode: str = "sum"

    @classmethod
    def tiny(cls):
        return cls(clip=CLIPVisionConfig.tiny(), context_dim=64, arcface_stages=((16, 1), (32, 1)))


class Conditioner(nn.Module):
    """Builds the (B, 1, context_dim) conditioning token and the uncond token."""

    def __init__(self, cfg: ConditionerConfig = ConditionerConfig()):
        super().__init__()
        if cfg.mode != "sum":
            raise ValueError(f"conditioning mode {cfg.mode!r} is not ported")
        self.cfg = cfg
        d = cfg.context_dim
        self.clip_encoder = CLIPConditioner(dataclasses.replace(cfg.clip, projection_dim=d))
        self.arcface = IRSE50(stages=cfg.arcface_stages)
        self.proj_out_source = Dense(d, d)
        self.proj_out_target = Dense(d, d)
        self.id_proj_out = Dense(512, d)
        self.landmark_proj_out = Dense(LANDMARK_DIM, d)
        self.learnable_vector = nn.Parameter(torch.zeros(1, 1, d))

    def uncond(self, batch: int) -> torch.Tensor:
        return self.learnable_vector.expand(batch, 1, self.cfg.context_dim)

    def forward(self, src_clip_pixels: torch.Tensor, landmarks136: Optional[torch.Tensor] = None,
                tar_clip_pixels: Optional[torch.Tensor] = None,
                src_face01: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src/tar_clip_pixels: CLIP-normalised NHWC; src_face01: the [0, 1]
        source face for the ArcFace branch; landmarks136: (B, 136)."""
        cfg = self.cfg
        c = self.proj_out_source(self.clip_encoder(src_clip_pixels))
        if cfg.target_clip_feat and tar_clip_pixels is not None:
            c = c + self.proj_out_target(self.clip_encoder(tar_clip_pixels))
        c2 = torch.zeros_like(c)
        if cfg.id_weight > 0 and src_face01 is not None:
            # ID_proj_out consumes the normalised embedding
            feats = safe_l2_normalize(self.arcface(arcface_preprocess(src_face01)))
            c2 = self.id_proj_out(feats)[:, None, :]
        total = cfg.clip_weight + (cfg.id_weight if cfg.id_weight > 0 else 0.0)
        cond = c * cfg.clip_weight + c2 * cfg.id_weight
        if cfg.landmark_cond and landmarks136 is not None:
            lm_raw = landmarks136.to(torch.float32)
            if lm_raw.ndim == 2:
                lm_raw = lm_raw[:, None, :]
            cond = cond + self.landmark_proj_out(lm_raw) * cfg.landmarks_weight
            total += cfg.landmarks_weight
        if cfg.weight_division:
            cond = cond / total
        return cond
