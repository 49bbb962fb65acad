"""The REFace conditioning token builder, PyTorch.

Port of ``vface_tpu/models/conditioning.py``. The shipped "sum" mode:

    c_clip = proj_out_source(CLIP(src)) [+ proj_out_target(CLIP(tar))]
    c_id   = id_proj_out(l2norm(ArcFace(src_face)))       # (B, 1, D)
    c_lm   = landmark_proj_out(landmarks_136)             # (B, 1, D)
    c      = (w_clip*c_clip + w_id*c_id + w_lm*c_lm) / (w_clip + w_id + w_lm)

plus the learnable unconditional vector for CFG and condition dropout. The
other token modes:

* "concat": ``concat_feat_proj(cat(c_clip, c_id, landmarks_136))``, one
  D-wide token;
* "stack": the tokens c_clip, c_id and c_lm on the sequence axis (B, 3, D);
  the uncond is ``learnable_vector`` followed by ``other_learnable_vector``'s
  two tokens;
* "sep_head": ``cat((w_clip*c_clip + w_id*c_id) / (w_clip + w_id), c_lm)``,
  one 2D-wide token for the UNet's dual context; the uncond is
  ``learnable_vector`` twice over its width.
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
MODES = ("sum", "concat", "stack", "sep_head")


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
    """Builds the conditioning tokens and the uncond tokens: (B, 1, D) in the
    "sum" and "concat" modes, (B, 3, D) in "stack", (B, 1, 2D) in "sep_head"."""

    def __init__(self, cfg: ConditionerConfig = ConditionerConfig()):
        super().__init__()
        if cfg.mode not in MODES:
            raise ValueError(f"conditioning mode {cfg.mode!r}: one of {MODES}")
        self.cfg = cfg
        d = cfg.context_dim
        self.clip_encoder = CLIPConditioner(dataclasses.replace(cfg.clip, projection_dim=d))
        self.arcface = IRSE50(stages=cfg.arcface_stages)
        self.proj_out_source = Dense(d, d)
        self.proj_out_target = Dense(d, d)
        self.id_proj_out = Dense(512, d)
        self.landmark_proj_out = Dense(LANDMARK_DIM, d)
        if cfg.mode == "concat":
            self.concat_feat_proj = Dense(2 * d + LANDMARK_DIM, d)
        self.learnable_vector = nn.Parameter(torch.zeros(1, 1, d))
        if cfg.mode == "stack":
            self.other_learnable_vector = nn.Parameter(torch.zeros(1, 2, d))

    def uncond(self, batch: int) -> torch.Tensor:
        uc = self.learnable_vector
        if self.cfg.mode == "stack":
            uc = torch.cat([uc, self.other_learnable_vector], dim=1)
        elif self.cfg.mode == "sep_head":
            uc = torch.cat([uc, uc], dim=-1)
        return uc.expand((batch,) + uc.shape[1:])

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
        lm_raw, lm = None, torch.zeros_like(c)
        if landmarks136 is not None:
            lm_raw = landmarks136.to(torch.float32)
            if lm_raw.ndim == 2:
                lm_raw = lm_raw[:, None, :]
            lm = self.landmark_proj_out(lm_raw)
        if cfg.mode == "concat":
            if lm_raw is None:
                lm_raw = c.new_zeros(c.shape[:2] + (LANDMARK_DIM,))
            return self.concat_feat_proj(torch.cat([c, c2, lm_raw], dim=-1))
        if cfg.mode == "stack":
            return torch.cat([c, c2, lm], dim=1)
        total = cfg.clip_weight + (cfg.id_weight if cfg.id_weight > 0 else 0.0)
        cond = c * cfg.clip_weight + c2 * cfg.id_weight
        if cfg.mode == "sep_head":
            return torch.cat([cond / total if cfg.weight_division else cond, lm], dim=-1)
        if cfg.landmark_cond and landmarks136 is not None:
            cond = cond + lm * cfg.landmarks_weight
            total += cfg.landmarks_weight
        if cfg.weight_division:
            cond = cond / total
        return cond
