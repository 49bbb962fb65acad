"""Pose metric: Hopenet yaw / pitch / roll L2 (port of ``vface_tpu/eval/pose.py``).

ResNet-50 with three 66-bin heads; the angle is the softmax expectation over
the bins in degrees: (sum_i softmax(logits)_i * i) * 3 - 99.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from vface_torch.eval._common import eval_net, extract
from vface_torch.eval.backbones import ResNet50
from vface_torch.models.layers import Dense
from vface_torch.ops.warp import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Hopenet(nn.Module):
    """(B, 224, 224, 3) NHWC, ImageNet-normalised -> (yaw, pitch, roll) logits (B, bins) each."""

    def __init__(self, bins: int = 66):
        super().__init__()
        self.backbone = ResNet50()
        self.fc_yaw = Dense(2048, bins)
        self.fc_pitch = Dense(2048, bins)
        self.fc_roll = Dense(2048, bins)

    def forward(self, x: torch.Tensor):
        feat = self.backbone(x)
        return self.fc_yaw(feat), self.fc_pitch(feat), self.fc_roll(feat)


def logits_to_degrees(logits: torch.Tensor) -> torch.Tensor:
    prob = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    return (prob * idx).sum(dim=-1) * 3.0 - 99.0


def head_pose(params, images01, model=None, batch: int = 32, device="cuda") -> np.ndarray:
    """[0, 1] face crops -> (B, 3) (yaw, pitch, roll) degrees: 224^2 (bilinear,
    antialiased), ImageNet normalisation; ``params`` a ``Hopenet`` state dict."""
    net = eval_net(Hopenet, model if model is not None else params, device)

    def f(x):
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        yaw, pitch, roll = net((resize_bilinear(x, 224, 224) - mean) / std)
        return torch.stack([logits_to_degrees(yaw), logits_to_degrees(pitch), logits_to_degrees(roll)], dim=-1)

    return extract(f, images01, batch, net)


def pose_l2(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """The mean L2 of the (yaw, pitch, roll) differences."""
    return float(np.linalg.norm(np.asarray(pose_a) - np.asarray(pose_b), axis=-1).mean())
