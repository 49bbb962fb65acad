"""The benchmark reference's frozen copy of ``vface_torch/models/raft.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

RAFT-large optical flow, PyTorch: the FGATS flow source.

Port of ``vface_tpu/models/raft.py`` (the RAFT paper, Teed & Deng, ECCV 2020,
in torchvision's ``raft_large`` geometry): an instance-norm feature encoder to
256-d features at 1/8 scale, a frozen-BN context encoder to a 128-d hidden
state (tanh) and 128-d context (relu), a 4-level all-pairs correlation pyramid
read with radius-4 windows (324 channels), the SepConvGRU update with its
flow and convex-upsampling mask heads, ``RAFTConfig.iters`` refinement steps
with shared weights, and the 8x convex upsampling.

The correlation volume is one float32 product (TF32 must be off on the card
for it to match the reference); the window lookup is JAX's gather-free form,
two batched products against triangle-kernel weights whose out-of-range taps
weigh zero (``F.grid_sample``'s zero padding, which torchvision's lookup
uses), windows ordered dy-major. Frames in [-1, 1], NHWC at the boundary,
H and W divisible by 8; flow out (B, H, W, 2) in pixels (dx, dy).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.arcface import FrozenBN
from benchmark.reference.layers import Conv


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H, W (population variance,
    eps 1e-5) with a learned scale and bias; NCHW."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


def _norm(kind: str, c: int) -> nn.Module:
    return InstanceNorm(c) if kind == "instance" else FrozenBN(c)


class ResidualUnit(nn.Module):
    def __init__(self, in_ch: int, ch: int, stride: int = 1, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv(in_ch, ch, kernel=3, stride=stride, padding=1)
        self.norm1 = _norm(norm, ch)
        self.conv2 = Conv(ch, ch, kernel=3, padding=1)
        self.norm2 = _norm(norm, ch)
        if stride != 1 or in_ch != ch:
            self.downsample = Conv(in_ch, ch, kernel=1, stride=stride, padding=0)
            self.norm3 = _norm(norm, ch)
        else:
            self.downsample = None

    def forward(self, x):
        h = torch.relu(self.norm1(self.conv1(x)))
        h = torch.relu(self.norm2(self.conv2(h)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return torch.relu(x + h)


class RAFTEncoder(nn.Module):
    LAYERS = ((64, 1), (64, 1), (96, 2), (96, 1), (128, 2), (128, 1))

    def __init__(self, out_ch: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv(3, 64, kernel=7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        ch = 64
        for i, (out, stride) in enumerate(self.LAYERS):
            self.add_module(f"layer_{i}", ResidualUnit(ch, out, stride, norm))
            ch = out
        self.conv2 = Conv(ch, out_ch, kernel=1)

    def forward(self, x):
        h = torch.relu(self.norm1(self.conv1(x)))
        for i in range(len(self.LAYERS)):
            h = getattr(self, f"layer_{i}")(h)
        return self.conv2(h)


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4):
    """All-pairs correlation of NCHW features f1, f2 (B, C, H, W) ->
    [(B, H, W, H / 2^l, W / 2^l)] per level (float32)."""
    b, c, h, w = f1.shape
    a = f1.to(torch.float32).reshape(b, c, h * w).transpose(1, 2)
    corr = torch.matmul(a, f2.to(torch.float32).reshape(b, c, h * w)) / float(c) ** 0.5
    pyramid = [corr.reshape(b, h, w, h, w)]
    cur = corr.reshape(b * h * w, 1, h, w)
    for _ in range(levels - 1):
        if min(cur.shape[2], cur.shape[3]) >= 2:
            cur = F.avg_pool2d(cur, 2, stride=2)
        # else: tiny inputs keep the 1x1 level instead of pooling it away
        pyramid.append(cur.reshape(b, h, w, cur.shape[2], cur.shape[3]))
    return pyramid


def lookup_corr(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Each level sampled in a (2r+1)^2 window around coords (B, H, W, 2) in
    level-0 pixels (x, y) -> (B, H, W, levels * (2r+1)^2), dy-major.

    Bilinear sampling is a linear map of the source rows and columns, so the
    window is two batched products against triangle weights; coordinates are
    not clamped, so an out-of-range tap weighs zero (zero padding)."""
    b, h, w, _ = coords.shape
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    n = b * h * w
    out = []
    for lvl, corr in enumerate(pyramid):
        hh, ww = corr.shape[3], corr.shape[4]
        ctr = coords.reshape(n, 2) / (2.0**lvl)
        sy = ctr[:, 1:2] + d[None, :]
        sx = ctr[:, 0:1] + d[None, :]
        wy = torch.clamp(1.0 - (sy[:, :, None] - torch.arange(hh, dtype=torch.float32, device=coords.device)).abs(),
                         min=0.0)
        wx = torch.clamp(1.0 - (sx[:, :, None] - torch.arange(ww, dtype=torch.float32, device=coords.device)).abs(),
                         min=0.0)
        tmp = torch.bmm(wy, corr.reshape(n, hh, ww))
        out.append(torch.bmm(tmp, wx.transpose(1, 2)).reshape(b, h, w, k * k))
    return torch.cat(out, dim=-1)


class MotionEncoder(nn.Module):
    def __init__(self, corr_ch: int = 324):
        super().__init__()
        self.convc1 = Conv(corr_ch, 256, kernel=1)
        self.convc2 = Conv(256, 192, kernel=3, padding=1)
        self.convf1 = Conv(2, 128, kernel=7, padding=3)
        self.convf2 = Conv(128, 64, kernel=3, padding=1)
        self.conv = Conv(256, 126, kernel=3, padding=1)

    def forward(self, flow, corr):
        c = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        f = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        return torch.cat([torch.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, inp: int = 256):
        super().__init__()
        for name, ks in (("horiz", (1, 5)), ("vert", (5, 1))):
            pad = (ks[0] // 2, ks[1] // 2)
            for gate in "zrq":
                self.add_module(f"{name}_{gate}", Conv(hidden + inp, hidden, kernel=ks, padding=pad))

    def _gru(self, h, x, name: str):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"{name}_z")(hx))
        r = torch.sigmoid(getattr(self, f"{name}_r")(hx))
        q = torch.tanh(getattr(self, f"{name}_q")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._gru(self._gru(h, x, "horiz"), x, "vert")


class UpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128, corr_ch: int = 324):
        super().__init__()
        self.motion = MotionEncoder(corr_ch)
        self.gru = SepConvGRU(hidden, 256)
        self.flow_head1 = Conv(hidden, 256, kernel=3, padding=1)
        self.flow_head2 = Conv(256, 2, kernel=3, padding=1)
        self.mask1 = Conv(hidden, 256, kernel=3, padding=1)
        self.mask2 = Conv(256, 64 * 9, kernel=1)

    def forward(self, h, context, corr, flow):
        x = torch.cat([context, self.motion(flow, corr)], dim=1)
        h = self.gru(h, x)
        delta = self.flow_head2(torch.relu(self.flow_head1(h)))
        mask = self.mask2(torch.relu(self.mask1(h))) * 0.25
        return h, delta, mask


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex-combination upsampling: flow (B, h, w, 2), mask (B, h, w, 576)
    -> (B, 8h, 8w, 2)."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    fp = F.pad(flow * 8.0, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([fp[:, i : i + h, j : j + w, :] for i in range(3) for j in range(3)], dim=3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    iters: int = 20
    corr_levels: int = 4
    corr_radius: int = 4


class RAFT(nn.Module):
    """raft_large: ``forward(img1, img2)`` -> flow (B, H, W, 2) from img1's grid to img2."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = RAFTEncoder(256, "instance")
        self.cnet = RAFTEncoder(256, "batch")
        self.update = UpdateBlock(128, cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, _ = img1.shape
        h8, w8 = hh // 8, ww // 8
        nchw = lambda t: t.to(torch.float32).permute(0, 3, 1, 2)
        fmaps = self.fnet(torch.cat([nchw(img1), nchw(img2)], dim=0))
        pyramid = correlation_pyramid(fmaps[:b], fmaps[b:], cfg.corr_levels)
        cnet = self.cnet(nchw(img1))
        hid, context = torch.tanh(cnet[:, :128]), torch.relu(cnet[:, 128:])
        dev = img1.device
        ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=dev),
                                torch.arange(w8, dtype=torch.float32, device=dev), indexing="ij")
        base = torch.stack([xs, ys], dim=-1)[None].expand(b, h8, w8, 2)
        flow = torch.zeros((b, h8, w8, 2), dtype=torch.float32, device=dev)
        mask = torch.zeros((b, 64 * 9, h8, w8), dtype=torch.float32, device=dev)
        for _ in range(cfg.iters):
            corr = lookup_corr(pyramid, base + flow, cfg.corr_radius).permute(0, 3, 1, 2)
            hid, delta, mask = self.update(hid, context, corr, flow.permute(0, 3, 1, 2))
            flow = flow + delta.permute(0, 2, 3, 1)
        return convex_upsample(flow, mask.permute(0, 2, 3, 1))
