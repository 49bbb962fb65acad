"""face-vid2vid, the one-shot free-view talking-head generator, PyTorch.

Port of ``vface_tpu/models/face_vid2vid.py`` (REFace's
``eval_tool/face_vid2vid/modules``: ``KPDetector``, ``HEEstimator``,
``dense_motion.py``, ``OcclusionAwareGenerator``), which makes the driven
comparison videos of the qualitative eval (Wang et al., "One-Shot Free-View
Neural Talking-Head Synthesis", CVPR 2021):

* appearance encoder: 2-D downsamples -> a 3-D feature volume (depth D);
* canonical 3-D keypoints: a 3-D hourglass -> K softmax heatmaps -> expected
  coordinates;
* head pose and expression: a conv trunk -> (yaw, pitch, roll) bins, a
  translation and per-keypoint deltas; ``kp = R(yaw, pitch, roll) kp_c + t + delta``;
* dense motion: K sparse flows from keypoint pairs and the Gaussian heatmap
  difference -> a 3-D hourglass -> K + 1 masks -> a dense 3-D flow and a 2-D
  occlusion map;
* generator: the source volume warped by the flow (trilinear), depth folded
  into channels, an occlusion-masked 2-D decoder.

Images are NHWC in [0, 1] at the public functions; NCHW / NCDHW inside. A
volume (B, C, D, H, W) is JAX's (B, D, H, W, C); folding depth into channels
keeps JAX's order (channel d * C + c). Parameter names mirror the Flax tree
(``appearance.first.weight`` is ``appearance/first/kernel``; 3-D kernels
DHWIO -> OIDHW in :func:`vface_torch.utils.convert.flax_tree_to_state_dict`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.arcface import FrozenBN
from vface_torch.models.layers import Conv, Dense, upsample_nearest_2x


@dataclasses.dataclass(frozen=True)
class FV2VConfig:
    num_kp: int = 15
    block_expansion: int = 64
    max_features: int = 512
    depth: int = 16  # feature-volume depth D
    image_size: int = 256
    reshape_channel: int = 32

    @classmethod
    def tiny(cls):
        return cls(num_kp=5, block_expansion=8, max_features=32, depth=4, image_size=32, reshape_channel=8)


class Conv3d(nn.Module):
    """k^3 convolution on NCDHW, float32, padding (k - 1) // 2 on every side."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.padding = (kernel - 1) // 2
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, padding=self.padding)


def _upsample_hw_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x over the last two dims (JAX's nearest resize at an integer factor)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class DownBlock2d(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv = Conv(in_ch, ch, kernel=3, padding=1)
        self.bn = FrozenBN(ch)

    def forward(self, x):
        return F.avg_pool2d(torch.relu(self.bn(self.conv(x))), 2)


class UpBlock3d(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv = Conv3d(in_ch, ch)
        self.bn = FrozenBN(ch)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(_upsample_hw_2x(x))))


class DownBlock3d(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv = Conv3d(in_ch, ch)
        self.bn = FrozenBN(ch)

    def forward(self, x):
        return F.avg_pool3d(torch.relu(self.bn(self.conv(x))), (1, 2, 2))


class Hourglass3d(nn.Module):
    """Symmetric 3-D encoder-decoder with skip concats; out channels ``out_channels``."""

    def __init__(self, in_ch: int, base: int, levels: int = 3):
        super().__init__()
        self.levels = levels
        skips = [in_ch]
        for i in range(levels):
            self.add_module(f"down_{i}", DownBlock3d(skips[-1], min(base * 2 ** (i + 1), 256)))
            skips.append(min(base * 2 ** (i + 1), 256))
        ch = skips.pop()
        for i in range(levels):
            out = min(base * 2 ** (levels - i - 1), 256)
            self.add_module(f"up_{i}", UpBlock3d(ch, out))
            ch = out + skips.pop()
        self.out_channels = ch

    def forward(self, x):
        skips = [x]
        h = x
        for i in range(self.levels):
            h = getattr(self, f"down_{i}")(h)
            skips.append(h)
        out = skips.pop()
        for i in range(self.levels):
            out = torch.cat([getattr(self, f"up_{i}")(out), skips.pop()], dim=1)
        return out


class AppearanceEncoder(nn.Module):
    """Source image (B, 3, H, W) -> the 3-D feature volume (B, reshape_channel, depth, H/4, W/4)."""

    def __init__(self, cfg: FV2VConfig):
        super().__init__()
        self.cfg = cfg
        be = cfg.block_expansion
        self.first = Conv(3, be, kernel=7, padding=3)
        self.first_bn = FrozenBN(be)
        self.down_0 = DownBlock2d(be, be * 2)
        self.down_1 = DownBlock2d(be * 2, min(be * 4, cfg.max_features))
        self.to_volume = Conv(min(be * 4, cfg.max_features), cfg.reshape_channel * cfg.depth, kernel=1)

    def forward(self, img):
        cfg = self.cfg
        h = self.down_1(self.down_0(torch.relu(self.first_bn(self.first(img)))))
        h = self.to_volume(h)
        b, _, hh, ww = h.shape
        # JAX's channel split: depth major, then reshape_channel
        return h.reshape(b, cfg.depth, cfg.reshape_channel, hh, ww).permute(0, 2, 1, 3, 4)


def _grid(d: int, h: int, w: int, device) -> torch.Tensor:
    """(D, H, W, 3) normalised (x, y, z) coordinates in [-1, 1]."""
    zz, yy, xx = torch.meshgrid(torch.linspace(-1, 1, d, device=device), torch.linspace(-1, 1, h, device=device),
                                torch.linspace(-1, 1, w, device=device), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


class CanonicalKPDetector(nn.Module):
    """Volume -> canonical 3-D keypoints (B, K, 3) by softmax heatmap expectation."""

    def __init__(self, cfg: FV2VConfig):
        super().__init__()
        self.hourglass = Hourglass3d(cfg.reshape_channel, cfg.reshape_channel)
        self.kp_head = Conv3d(self.hourglass.out_channels, cfg.num_kp)

    def forward(self, volume):
        heat = self.kp_head(self.hourglass(volume))
        b, k, d, hh, ww = heat.shape
        prob = torch.softmax(heat.reshape(b, k, d * hh * ww).to(torch.float32), dim=-1)
        return prob @ _grid(d, hh, ww, heat.device).reshape(-1, 3)


class PoseExpressionNet(nn.Module):
    """Image -> (yaw, pitch, roll) bin logits, translation (B, 3), deltas (B, K, 3)."""

    def __init__(self, cfg: FV2VConfig, bins: int = 66):
        super().__init__()
        self.num_kp = cfg.num_kp
        chans = [3, cfg.block_expansion, cfg.block_expansion * 2, cfg.max_features]
        for i in range(3):
            self.add_module(f"conv_{i}", Conv(chans[i], chans[i + 1], kernel=3, stride=2, padding=1))
            self.add_module(f"bn_{i}", FrozenBN(chans[i + 1]))
        f = cfg.max_features
        self.fc_yaw, self.fc_pitch, self.fc_roll = Dense(f, bins), Dense(f, bins), Dense(f, bins)
        self.fc_t = Dense(f, 3)
        self.fc_delta = Dense(f, 3 * cfg.num_kp)

    def forward(self, img):
        h = img
        for i in range(3):
            h = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(h)))
        feat = h.mean(dim=(2, 3))
        return (self.fc_yaw(feat), self.fc_pitch(feat), self.fc_roll(feat), self.fc_t(feat),
                self.fc_delta(feat).reshape(-1, self.num_kp, 3))


def _angles_from_bins(logits: torch.Tensor) -> torch.Tensor:
    prob = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    return ((prob * idx).sum(dim=-1) * 3.0 - 99.0) * math.pi / 180.0


def rotation_matrix(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """(B,) angles in radians -> (B, 3, 3) = R_yaw R_pitch R_roll."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    rp = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(-1, 3, 3)
    rr = torch.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(-1, 3, 3)
    return ry @ rp @ rr


def compose_keypoints(kp_canonical, yaw, pitch, roll, t, delta) -> torch.Tensor:
    """kp = R kp_c + t + delta; yaw / pitch / roll as bin logits."""
    r = rotation_matrix(_angles_from_bins(yaw), _angles_from_bins(pitch), _angles_from_bins(roll))
    return torch.einsum("bij,bkj->bki", r, kp_canonical) + t[:, None, :] + delta


def _kp_gaussians(kp: torch.Tensor, shape, sigma: float = 0.1) -> torch.Tensor:
    """(B, K, 3) keypoints -> (B, K, D, H, W) Gaussian volumes."""
    grid = _grid(*shape, kp.device)  # (D, H, W, 3)
    diff = grid[None, None] - kp[:, :, None, None, None, :]
    return torch.exp(-(diff**2).sum(dim=-1) / (2 * sigma**2))


class DenseMotionNetwork(nn.Module):
    """(volume, kp_driving, kp_source) -> (flow (B, D, H, W, 3) as (x, y, z), occlusion (B, 1, H, W))."""

    def __init__(self, cfg: FV2VConfig):
        super().__init__()
        self.num_kp = cfg.num_kp
        self.hourglass = Hourglass3d(cfg.reshape_channel + cfg.num_kp, cfg.reshape_channel)
        self.mask = Conv3d(self.hourglass.out_channels, cfg.num_kp + 1)
        self.occlusion = Conv(self.hourglass.out_channels, 1, kernel=7, padding=3)

    def forward(self, volume, kp_driving, kp_source):
        b, _, d, h, w = volume.shape
        heat = _kp_gaussians(kp_driving, (d, h, w)) - _kp_gaussians(kp_source, (d, h, w))
        feat = self.hourglass(torch.cat([volume, heat], dim=1))
        masks = torch.softmax(self.mask(feat).to(torch.float32), dim=1).permute(0, 2, 3, 4, 1)  # (B,D,H,W,K+1)
        # sparse motions: the identity and a translation per keypoint (first order without jacobians)
        ident = _grid(d, h, w, volume.device)[None]
        shifts = (kp_source - kp_driving)[:, None, None, None, :, :]  # (B,1,1,1,K,3)
        sparse = torch.cat([ident.expand(b, d, h, w, 3)[..., None, :], ident[..., None, :] + shifts], dim=-2)
        flow = (sparse * masks[..., None]).sum(dim=-2)
        occlusion = torch.sigmoid(self.occlusion(feat.mean(dim=2)).to(torch.float32))
        return flow, occlusion


def warp_volume(volume: torch.Tensor, flow_grid: torch.Tensor) -> torch.Tensor:
    """Trilinear warp of a volume (B, C, D, H, W) at normalised coordinates
    (B, D, H, W, 3 = x, y, z), corners on the volume's edge voxels
    (``align_corners``) and coordinates past [-1, 1] taking the edge voxel:
    JAX's corner-clamped gather (each corner's index clipped into the volume)
    gives the same values, since both corners past an edge clip to that edge."""
    return F.grid_sample(volume, flow_grid.to(volume.dtype), mode="bilinear", padding_mode="border",
                         align_corners=True)


class Decoder2d(nn.Module):
    """Occlusion-masked 2-D decoder back to image resolution: (B, 3, H, W) in (0, 1)."""

    def __init__(self, in_ch: int, max_features: int):
        super().__init__()
        self.dec_in = Conv(in_ch, max_features // 2, kernel=3, padding=1)
        cc = max_features // 2
        for i in range(2):
            self.add_module(f"dec_up_{i}", Conv(cc, max(cc // 2, 32), kernel=3, padding=1))
            cc = max(cc // 2, 32)
        self.dec_out = Conv(cc, 3, kernel=7, padding=3)

    def forward(self, feat2d):
        x = torch.relu(self.dec_in(feat2d))
        for i in range(2):
            x = torch.relu(getattr(self, f"dec_up_{i}")(upsample_nearest_2x(x)))
        return torch.sigmoid(self.dec_out(x).to(torch.float32))


class OcclusionAwareGenerator(nn.Module):
    """``forward(source, driving)``: (B, H, W, 3) images in [0, 1] -> the source
    animated with the driving image's pose and expression, (B, H, W, 3) in (0, 1)."""

    def __init__(self, cfg: FV2VConfig = FV2VConfig()):
        super().__init__()
        self.cfg = cfg
        self.appearance = AppearanceEncoder(cfg)
        self.kp_detector = CanonicalKPDetector(cfg)
        self.pose_net = PoseExpressionNet(cfg)
        self.dense_motion = DenseMotionNetwork(cfg)
        self.decoder = Decoder2d(cfg.depth * cfg.reshape_channel, cfg.max_features)

    @staticmethod
    def _nchw(img: torch.Tensor) -> torch.Tensor:
        return img.to(torch.float32).permute(0, 3, 1, 2)

    def extract_kp(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> the image's posed keypoints (B, K, 3)."""
        x = self._nchw(img)
        return compose_keypoints(self.kp_detector(self.appearance(x)), *self.pose_net(x))

    def forward(self, source_img: torch.Tensor, driving_img: torch.Tensor) -> torch.Tensor:
        src, drv = self._nchw(source_img), self._nchw(driving_img)
        vol = self.appearance(src)
        kp_c = self.kp_detector(vol)
        kp_source = compose_keypoints(kp_c, *self.pose_net(src))
        kp_driving = compose_keypoints(kp_c, *self.pose_net(drv))
        flow, occlusion = self.dense_motion(vol, kp_driving, kp_source)
        warped = warp_volume(vol, flow)  # (B, C, D, H, W)
        b, c, d, h, w = warped.shape
        feat2d = warped.permute(0, 2, 1, 3, 4).reshape(b, d * c, h, w) * occlusion
        return self.decoder(feat2d).permute(0, 2, 3, 1)


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights in place on the generator's device: conv and dense weights
    LeCun-normal (std 1 / sqrt(fan_in)), biases N(0, 0.02^2), frozen BatchNorms
    the identity; returns ``model``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Conv3d, Dense)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device) / math.sqrt(math.prod(w.shape[1:])))
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator, device=w.device) * 0.02)
    return model
