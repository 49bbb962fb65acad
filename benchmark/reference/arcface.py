"""The benchmark reference's frozen copy of ``vface_torch/models/arcface.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

ArcFace IR-SE-50 face-recognition backbone, PyTorch (frozen, inference BN).

Port of ``vface_tpu/models/arcface.py``: the 112x112 IR-SE-50 whose 512-d
embedding feeds the ID term of the conditioning token and the masked ID loss
of training. Stage plan (ir-50): depths (64, 128, 256, 512) x units
(3, 4, 14, 3), stride 2 at each stage entry; SE ratio 16; head BN -> flatten
in (C, H, W) order -> Linear(512*7*7, 512) -> BN. BatchNorm runs on frozen
running statistics, which are parameters here as in the JAX tree. The convs
have no bias and run in float32. Public functions take NHWC; NCHW inside.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from benchmark.reference.layers import Conv, Dense
from benchmark.reference.pooling import adaptive_avg_pool

IR_50_STAGES: Tuple[Tuple[int, int], ...] = ((64, 3), (128, 4), (256, 14), (512, 3))


class _FrozenBNParams(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def _apply_last(self, x: torch.Tensor) -> torch.Tensor:
        """(x32 - mean) * rsqrt(var + eps) * scale + bias over the last dim."""
        inv = torch.rsqrt(self.var.to(torch.float32) + self.eps) * self.weight
        return ((x.to(torch.float32) - self.mean) * inv + self.bias).to(x.dtype)


class FrozenBN(_FrozenBNParams):
    """BatchNorm on frozen statistics (scale/bias/mean/var) over dim 1: NCHW,
    or NCDHW (face-vid2vid's 3-D blocks)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_last(x.movedim(1, -1)).movedim(-1, 1)


class FrozenBN1D(_FrozenBNParams):
    """BatchNorm1d on frozen statistics over the last dim."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_last(x)


class PReLU(nn.Module):
    """Per-channel PReLU (torch ``nn.PReLU(C)`` semantics), NCHW."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype)[None, :, None, None]
        return torch.where(x >= 0, x, a * x)


class SEModule(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv(c, c // reduction, kernel=1, bias=False)
        self.fc2 = Conv(c // reduction, c, kernel=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s.to(torch.float32)).to(x.dtype)


class BottleneckIRSE(nn.Module):
    def __init__(self, in_ch: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if in_ch != depth:
            self.shortcut_conv = Conv(in_ch, depth, kernel=1, stride=stride, bias=False)
            self.shortcut_bn = FrozenBN(depth)
        else:
            self.shortcut_conv = None
        self.bn1 = FrozenBN(in_ch)
        self.conv1 = Conv(in_ch, depth, kernel=3, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv(depth, depth, kernel=3, stride=stride, bias=False)
        self.bn2 = FrozenBN(depth)
        self.se = SEModule(depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_conv is None:
            # the reference's MaxPool2d(1, stride) shortcut: a pure subsample
            shortcut = x if self.stride == 1 else x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        h = self.conv2(self.prelu(self.conv1(self.bn1(x))))
        return self.se(self.bn2(h)) + shortcut


class IRSE50(nn.Module):
    """(B, 112, 112, 3) NHWC in [-1, 1] -> the 512-d (unnormalised) embedding."""

    def __init__(self, stages: Tuple[Tuple[int, int], ...] = IR_50_STAGES, embed_dim: int = 512,
                 input_size: int = 112):
        super().__init__()
        self.input_conv = Conv(3, 64, kernel=3, bias=False)
        self.input_bn = FrozenBN(64)
        self.input_prelu = PReLU(64)
        ch, idx = 64, 0
        for depth, units in stages:
            for u in range(units):
                self.add_module(f"block_{idx}", BottleneckIRSE(ch, depth, 2 if u == 0 else 1))
                ch = depth
                idx += 1
        self.n_blocks = idx
        self.out_bn = FrozenBN(ch)
        side = input_size // 2 ** len(stages)
        self.out_fc = Dense(ch * side * side, embed_dim)
        self.out_feat_bn = FrozenBN1D(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_prelu(self.input_bn(self.input_conv(x.permute(0, 3, 1, 2))))
        for i in range(self.n_blocks):
            h = getattr(self, f"block_{i}")(h)
        h = self.out_bn(h)
        return self.out_feat_bn(self.out_fc(h.reshape(h.shape[0], -1)))  # (C, H, W) flatten order


def arcface_preprocess(images01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> the reference ID-loss input chain: adaptive
    average pool to 256^2 (unless already 256^2), centre crop rows 35:223 /
    cols 32:220, adaptive average pool to 112^2, scaled to [-1, 1]."""
    x = images01
    if x.shape[1] != 256 or x.shape[2] != 256:
        x = adaptive_avg_pool(x, 256, 256)
    x = x[:, 35:223, 32:220, :]
    return adaptive_avg_pool(x, 112, 112) * 2.0 - 1.0


def safe_l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along the last dim, with a finite gradient at x = 0."""
    n2 = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(n2, min=eps * eps))


def id_embedding(model: IRSE50, images01: torch.Tensor) -> torch.Tensor:
    """The L2-normalised 512-d ID embedding of (B, H, W, 3) images in [0, 1]
    through ``model`` (JAX's ``id_embedding(params, images01, model)``; the
    parameters are the module's)."""
    return safe_l2_normalize(model(arcface_preprocess(images01)))


def id_loss(feats_a: torch.Tensor, feats_b: torch.Tensor) -> torch.Tensor:
    """1 - the cosine similarity of two feature batches along the last dim,
    averaged over the batch."""
    a, b = safe_l2_normalize(feats_a), safe_l2_normalize(feats_b)
    return (1.0 - (a * b).sum(dim=-1)).mean()
