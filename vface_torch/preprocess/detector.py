"""Batched face detection for multi-face swapping.

Port of ``vface_tpu/preprocess/detector.py``: :class:`FaceDetector` (an
anchor-free centre-heatmap net, CenterNet style: peak heatmap, box size and
offset at 1/8 of a canonical 256^2 detection scale), :func:`decode_detections`
(max-pool NMS and the top K peaks, always K boxes and scores; callers threshold
the scores), :func:`crop_boxes` and :func:`load_default_detector_params`,
which reads the JAX package's shipped weights,
``vface_tpu/weights/detector.npz``, as a data file.

Conventions held to the JAX package's: the input featurisation is the
landmark net's (:func:`~vface_torch.preprocess.landmarks.photometric_features`);
Flax's ``nn.GroupNorm`` (eps 1e-6, the fast variance E[x^2] - E[x]^2) runs as
a plain float32 reduction; the top K takes tied scores lowest index first, as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.models.layers import Conv, GroupNorm32
from vface_torch.ops.warp import grid_sample
from vface_torch.preprocess.landmarks import photometric_features
from vface_torch.runtime.checkpoint import read_flat_npz

DEFAULT_DETECTOR_WEIGHTS = Path(__file__).resolve().parents[2] / "vface_tpu" / "weights" / "detector.npz"


class FaceDetector(nn.Module):
    """(B, H, W, 3) in [0, 1] -> heatmap (B, d/8, d/8, 1) in (0, 1), size (..., 2)
    and offset (..., 2), d = ``detect_size``.

    The frames are resized to d^2 and reduced to a standardised grey image and
    its x and y gradients (the landmark net's photometric-invariant
    featurisation); six 3x3 conv + GroupNorm + ReLU stages (three of stride 2)
    and three 1x1 heads. Boxes decoded from the maps live in detection space;
    ``decode_detections(..., image_hw=)`` maps them to frame pixels.
    """

    def __init__(self, width: int = 32, detect_size: int = 256):
        super().__init__()
        self.detect_size = detect_size
        w = width
        chans = [(3, w, 2), (w, 2 * w, 1), (2 * w, 2 * w, 2), (2 * w, 4 * w, 1), (4 * w, 4 * w, 2), (4 * w, 4 * w, 1)]
        for i, (ci, co, stride) in enumerate(chans):
            self.add_module(f"conv_{i}", Conv(ci, co, kernel=3, stride=stride, padding=1))
            self.add_module(f"gn_{i}", GroupNorm32(co, eps=1e-6, num_groups=8, use_kernel=False))
        self.heat = Conv(4 * w, 1, kernel=1)
        self.size = Conv(4 * w, 2, kernel=1)
        self.offset = Conv(4 * w, 2, kernel=1)
        self.n_stages = len(chans)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = photometric_features(x, self.detect_size)
        for i in range(self.n_stages):
            h = torch.relu(getattr(self, f"gn_{i}")(getattr(self, f"conv_{i}")(h)))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return torch.sigmoid(nhwc(self.heat(h)).to(torch.float32)), nhwc(self.size(h)), nhwc(self.offset(h))


def decode_detections(heat: torch.Tensor, size: torch.Tensor, offset: torch.Tensor, top_k: int = 4,
                      stride: int = 8, image_hw: Optional[Tuple[int, int]] = None):
    """-> boxes (B, K, 4) [cx, cy, w, h] in pixels and scores (B, K).

    A location survives only as the maximum of its 3x3 neighbourhood; the K
    highest survivors follow in descending score, ties lowest index first
    (after the NMS most entries are 0, so a map with fewer than K peaks picks
    among ties). ``image_hw``, the frames' size before the detector's resize,
    maps the boxes from detection space to frame pixels.
    """
    b, h, w, _ = heat.shape
    hm = heat[..., 0]
    pooled = F.max_pool2d(hm[:, None], 3, stride=1, padding=1)[:, 0]
    flat = torch.where(hm >= pooled, hm, torch.zeros_like(hm)).reshape(b, h * w)
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    ys, xs = (idx // w).to(torch.float32), (idx % w).to(torch.float32)
    pick = lambda m: torch.gather(m.reshape(b, h * w, 2), 1, idx[..., None].expand(-1, -1, 2))
    off_k, sz_k = pick(offset), pick(size)
    softplus = lambda v: torch.logaddexp(v, torch.zeros_like(v))  # jax.nn.softplus
    cx, cy = (xs + off_k[..., 0]) * stride, (ys + off_k[..., 1]) * stride
    bw, bh = softplus(sz_k[..., 0]) * stride, softplus(sz_k[..., 1]) * stride
    if image_hw is not None:
        sy, sx = image_hw[0] / (h * stride), image_hw[1] / (w * stride)
        cx, bw, cy, bh = cx * sx, bw * sx, cy * sy, bh * sy
    return torch.stack([cx, cy, bw, bh], dim=-1), scores


def crop_boxes(images01: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear crops of the boxes (B, K, 4) of images (B, H, W, C) -> (B, K, out, out, C)."""
    b, k, _ = boxes.shape
    u = (torch.arange(out_size, dtype=torch.float32, device=boxes.device) + 0.5) / out_size - 0.5
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    cx, cy, bw, bh = (boxes[..., i, None, None] for i in range(4))
    coords = torch.stack([cx + gx * bw, cy + gy * bh], dim=-1)  # (B, K, out, out, 2)
    out = grid_sample(images01, coords.reshape(b, k * out_size, out_size, 2))
    return out.reshape(b, k, out_size, out_size, images01.shape[-1])


def load_default_detector_params(path=DEFAULT_DETECTOR_WEIGHTS):
    """The shipped FaceDetector weights (distilled on multi-face synthetic
    scenes) as a Flax-style tree for :func:`vface_torch.utils.convert.from_flax_aux`,
    or None when the file is absent."""
    path = Path(path)
    return read_flat_npz(path) if path.exists() else None
