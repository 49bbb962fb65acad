"""LPIPS perceptual distance, AlexNet variant (port of ``vface_tpu/eval/lpips.py``).

The reference's ``eval_tool/lpips``: AlexNet's conv stack tapped after each of
its five ReLUs (3x3 stride-2 VALID max-pools after taps 0 and 1), each tap
unit-normalised over channels as ``x / (sqrt(sum x^2 + 1e-16) + 1e-10)``, the
squared difference weighted by a bias-free 1x1 ``lin{i}`` head, the spatial
mean, summed over the taps. The inputs pass the scaling layer first. Used
as the training loss's ``perceptual_fn`` (:func:`make_lpips_fn`); float32.
Parameter names mirror the Flax module's: ``net.conv{i}``, ``lin{i}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.layers import Conv
from vface_torch.utils.platform import resolve_device

_ALEX_PLAN = (  # (channels, kernel, stride, padding)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # a max-pool follows taps 0 and 1
_SHIFT = (-0.030, -0.088, -0.188)  # the LPIPS scaling layer
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """NCHW float32 -> the five ReLU taps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, p) in enumerate(_ALEX_PLAN):
            self.add_module(f"conv{i}", Conv(cin, ch, kernel=k, stride=s, padding=p))
            cin = ch

    def forward(self, x: torch.Tensor) -> list:
        taps = []
        for i in range(len(_ALEX_PLAN)):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """``forward(a, b)``: NHWC images in [-1, 1] -> (B,) perceptual distances."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, (ch, *_) in enumerate(_ALEX_PLAN):
            self.add_module(f"lin{i}", Conv(ch, 1, kernel=1, bias=False))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=a.device)
        scale = torch.tensor(_SCALE, device=a.device)
        prep = lambda x: ((x.to(torch.float32) - shift) / scale).permute(0, 3, 1, 2)
        unit = lambda x: x / (torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-16) + 1e-10)
        total = 0.0
        for i, (fa, fb) in enumerate(zip(self.net(prep(a)), self.net(prep(b)))):
            w = getattr(self, f"lin{i}")((unit(fa) - unit(fb)) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total


def make_lpips_fn(params: dict, device="cuda", model: LPIPS = None):
    """``(a, b) -> (B,)`` distances for the training loss's ``perceptual_fn``:
    an :class:`LPIPS` on ``device`` (the card unless the caller asks for the
    CPU) loaded with the state dict ``params`` and frozen (gradients reach the
    inputs only)."""
    model = model or LPIPS()
    model.load_state_dict(params)
    model.to(resolve_device(device)).requires_grad_(False)
    return model
