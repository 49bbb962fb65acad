"""The benchmark reference's frozen copy of ``vface_torch/models/bisenet.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

BiSeNet face parser (ResNet-18 trunk, 19 CelebAMask-HQ classes), PyTorch.

Port of ``vface_tpu/models/bisenet.py``: a ResNet-18 trunk (feat8, feat16,
feat32), a context path with two attention-refinement modules and a global
context vector, a feature-fusion module and the 19-class head at 1/8 scale,
upsampled to the input size (bilinear, align_corners=True). BatchNorm runs on
frozen statistics (:class:`~vface_torch.models.arcface.FrozenBN`); everything
is float32. Module names mirror the Flax tree, so
:func:`vface_torch.utils.convert.from_flax_aux` maps its params directly.
Public functions take NHWC; NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.arcface import FrozenBN
from benchmark.reference.layers import Conv
from benchmark.reference.warp import resize_bilinear, resize_nearest

N_PARSING_CLASSES = 19
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv(in_ch, ch, kernel=kernel, stride=stride, padding=kernel // 2, bias=False)
        self.bn = FrozenBN(ch)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, ch, kernel=3, stride=stride, padding=1, bias=False)
        self.bn1 = FrozenBN(ch)
        self.conv2 = Conv(ch, ch, kernel=3, padding=1, bias=False)
        self.bn2 = FrozenBN(ch)
        if stride != 1 or in_ch != ch:
            self.down_conv = Conv(in_ch, ch, kernel=1, stride=stride, padding=0, bias=False)
            self.down_bn = FrozenBN(ch)
        else:
            self.down_conv = None

    def forward(self, x):
        h = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        if self.down_conv is not None:
            x = self.down_bn(self.down_conv(x))
        return torch.relu(x + h)


class ResNet18Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, kernel=7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        ch = 64
        for layer, out in enumerate((64, 128, 256, 512), start=1):
            for i in range(2):
                stride = 2 if (i == 0 and layer > 1) else 1
                self.add_module(f"layer{layer}_{i}", BasicBlock(ch, out, stride))
                ch = out

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = []
        for layer in range(1, 5):
            for i in range(2):
                h = getattr(self, f"layer{layer}_{i}")(h)
            feats.append(h)
        return feats[1], feats[2], feats[3]  # feat8, feat16, feat32


class AttentionRefinement(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, ch, 3)
        self.conv_atten = Conv(ch, ch, kernel=1, bias=False)
        self.bn_atten = FrozenBN(ch)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


def _resize_nearest_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize_nearest(x.permute(0, 2, 3, 1), h, w).permute(0, 3, 1, 2)


def resize_bilinear_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NCHW x with align_corners=True (no antialiasing), the
    corner-aligned grid gathered explicitly as the JAX package does."""
    ih, iw = x.shape[2], x.shape[3]
    if (ih, iw) == (h, w):
        return x
    dev = x.device
    ys = torch.linspace(0.0, ih - 1.0, h, device=dev) if h > 1 else torch.zeros(1, device=dev)
    xs = torch.linspace(0.0, iw - 1.0, w, device=dev) if w > 1 else torch.zeros(1, device=dev)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = torch.clamp(y0 + 1, max=ih - 1), torch.clamp(x0 + 1, max=iw - 1)
    wy, wx = (ys - y0)[None, None, :, None], (xs - x0)[None, None, None, :]
    r0, r1 = x[:, :, y0], x[:, :, y1]
    top = r0[..., x0] * (1 - wx) + r0[..., x1] * wx
    bot = r1[..., x0] * (1 - wx) + r1[..., x1] * wx
    return top * (1 - wy) + bot * wy


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18Trunk()
        self.conv_avg = ConvBNReLU(512, 128, 1)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3)
        self.arm16 = AttentionRefinement(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128, 3)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = self.conv_head32(_resize_nearest_nchw(feat32_sum, feat16.shape[2], feat16.shape[3]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(_resize_nearest_nchw(feat16_sum, feat8.shape[2], feat8.shape[3]))
        return feat8, feat16_up, feat32_up


class FeatureFusion(nn.Module):
    def __init__(self, in_ch: int = 256, ch: int = 256):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, ch, 1)
        self.conv1 = Conv(ch, ch // 4, kernel=1, bias=False)
        self.conv2 = Conv(ch // 4, ch, kernel=1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = self.conv2(torch.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True))))
        return feat * torch.sigmoid(atten) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, n_classes: int = N_PARSING_CLASSES):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid_ch, 3)
        self.conv_out = Conv(mid_ch, n_classes, kernel=1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """(B, H, W, 3) ImageNet-normalised -> (B, H, W, 19) logits."""

    def __init__(self, n_classes: int = N_PARSING_CLASSES):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[1], x.shape[2]
        feat_res8, feat_cp8, _ = self.cp(x.permute(0, 3, 1, 2).to(torch.float32))
        out = self.conv_out(self.ffm(feat_res8, feat_cp8))
        return resize_bilinear_align_corners(out, hh, ww).permute(0, 2, 3, 1)


def parsing_preprocess(images01: torch.Tensor, size: int = 512) -> torch.Tensor:
    """[0, 1] images -> ``size``^2 ImageNet-normalised (bilinear, antialiased when downsampling)."""
    x = resize_bilinear(images01, size, size)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def parse_faces(model: BiSeNet, images01: torch.Tensor, size: int = 512) -> torch.Tensor:
    """[0, 1] images -> (B, size, size) int32 class map (argmax of the logits)."""
    return model(parsing_preprocess(images01, size)).argmax(dim=-1).to(torch.int32)
