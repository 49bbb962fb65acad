"""Shared eval backbones: the torchvision-style ResNet-50 on frozen BatchNorm.

Port of ``vface_tpu/eval/backbones.py``. Used by the pose metric (Hopenet:
ResNet-50 and three 66-bin heads) and the expression metric
(Deep3DFaceRecon's ``net_recon``: ResNet-50 to 257 coefficients). The
parameter names mirror the Flax modules' (``conv1``, ``bn1``,
``layer{s}_{b}.conv1`` ...), so :func:`vface_torch.utils.convert.from_flax_eval`
maps the JAX package's trees. float32; public functions take NHWC, NCHW inside.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.arcface import FrozenBN
from vface_torch.models.layers import Conv


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to ``ch * 4``, frozen BN, the projection
    shortcut where the stride or the width changes. NCHW."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        out_ch = ch * 4
        self.conv1 = Conv(in_ch, ch, kernel=1, bias=False)
        self.bn1 = FrozenBN(ch)
        self.conv2 = Conv(ch, ch, kernel=3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(ch)
        self.conv3 = Conv(ch, out_ch, kernel=1, bias=False)
        self.bn3 = FrozenBN(out_ch)
        self.down_conv = self.down_bn = None
        if stride != 1 or in_ch != out_ch:
            self.down_conv = Conv(in_ch, out_ch, kernel=1, stride=stride, padding=0, bias=False)
            self.down_bn = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x))
        return torch.relu(x + h)


class ResNet50(nn.Module):
    """(B, H, W, 3) NHWC -> the 2048-d global-average-pooled feature."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv(3, 64, kernel=7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        self.blocks = []
        cin = 64
        for stage, (blocks, ch) in enumerate(zip(layers, (64, 128, 256, 512))):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(cin, ch, 2 if (b == 0 and stage > 0) else 1))
                self.blocks.append(name)
                cin = ch * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2).to(torch.float32))))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))
