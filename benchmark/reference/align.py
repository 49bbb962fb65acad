"""The benchmark reference's frozen copy of ``vface_torch/preprocess/align.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

FFHQ-style face alignment, batched: quads, crops, paste-back.

Port of ``vface_tpu/preprocess/align.py``, built on the port's
:func:`~vface_torch.ops.warp.grid_sample` (bilinear, border-clamped):

* :func:`compute_quad`: the oriented crop rectangle from 68 landmarks;
* :func:`quad_crop`: PIL's ``Image.transform(QUAD, BILINEAR)`` as one batched
  bilinear gather;
* :func:`perspective_coefficients`: the 8-coefficient least-squares inverse
  transform for paste-back (numpy on the host, float32 out);
* :func:`perspective_warp`: PIL's ``Image.transform(PERSPECTIVE)``, batched;
* :func:`paste_back`: composite the swapped crops into the frames through the
  inverse transform, crop and mask warped together, zero weight outside.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.warp import grid_sample


def compute_quad(landmarks68: torch.Tensor, scale: float = 1.0):
    """(..., 68, 2) landmarks (x, y) -> quad (..., 4, 2) and qsize (...).

    Vertex order [c-x-y, c-x+y, c+x+y, c+x-y]: top-left, bottom-left,
    bottom-right, top-right in source coordinates.
    """
    lm = landmarks68.to(torch.float32)
    eye_left = lm[..., 36:42, :].mean(dim=-2)
    eye_right = lm[..., 42:48, :].mean(dim=-2)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[..., 48, :] + lm[..., 54, :]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg
    rot = torch.stack([-eye_to_mouth[..., 1], -eye_to_mouth[..., 0]], dim=-1)  # flipud(e2m) * [-1, 1]
    x = eye_to_eye - rot
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    extent = torch.maximum(torch.linalg.norm(eye_to_eye, dim=-1) * 2.0,
                           torch.linalg.norm(eye_to_mouth, dim=-1) * 1.8)
    x = x * extent[..., None] * scale
    y = torch.stack([-x[..., 1], x[..., 0]], dim=-1)
    c = eye_avg + eye_to_mouth * 0.1
    quad = torch.stack([c - x - y, c - x + y, c + x + y, c + x - y], dim=-2)
    return quad, torch.linalg.norm(x, dim=-1) * 2.0


def quad_crop(img: torch.Tensor, quad: torch.Tensor, size: int) -> torch.Tensor:
    """Batched PIL QUAD transform: img (B, H, W, C), quad (B, 4, 2) -> (B, size, size, C).

    Output pixel (u, v) samples the bilinear interpolation of the quad corners
    at the pixel centre.
    """
    t = (torch.arange(size, dtype=torch.float32, device=img.device) + 0.5) / size
    vv, uu = torch.meshgrid(t, t, indexing="ij")
    uu, vv = uu[None, :, :, None], vv[None, :, :, None]
    tl, bl, br, tr = (quad[:, i, None, None, :] for i in range(4))
    top = tl * (1 - uu) + tr * uu
    bot = bl * (1 - uu) + br * uu
    return grid_sample(img, top * (1 - vv) + bot * vv)


def perspective_coefficients(pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    """The 8 coefficients (a..h) of the perspective map pb -> pa:
    x_src = (a x + b y + c) / (g x + h y + 1), y_src = (d x + e y + f) / (g x + h y + 1).
    A least-squares solve on the host in float64, returned as float32."""
    pa = np.asarray(pa, dtype=np.float64)
    pb = np.asarray(pb, dtype=np.float64)
    m = []
    for p1, p2 in zip(pa, pb):
        m.append([p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]])
        m.append([0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0], -p2[1] * p1[1]])
    res, *_ = np.linalg.lstsq(np.asarray(m), pb.reshape(8), rcond=None)
    return res.astype(np.float32)


def _source_coords(coeffs: torch.Tensor, out_h: int, out_w: int):
    """Per output pixel of each frame, the (x, y) the perspective map samples."""
    dev = coeffs.device
    yy, xx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    a, b, c, d, e, f, g, h = (coeffs[:, i, None, None] for i in range(8))
    den = g * xx + h * yy + 1.0
    return (a * xx + b * yy + c) / den, (d * xx + e * yy + f) / den


def perspective_warp(img: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Batched PIL PERSPECTIVE transform: img (B, h, w, C), coeffs (B, 8) -> (B, out_h, out_w, C)."""
    sx, sy = _source_coords(coeffs, out_h, out_w)
    return grid_sample(img, torch.stack([sx, sy], dim=-1))


def paste_back(frame: torch.Tensor, swapped_crop: torch.Tensor, coeffs: torch.Tensor,
               mask_crop: torch.Tensor = None) -> torch.Tensor:
    """Composite swapped crops back into full frames.

    frame (B, H, W, 3) in [0, 1]; swapped_crop (B, s, s, 3); coeffs (B, 8)
    mapping frame pixel -> crop pixel; mask_crop (B, s, s, 1) a soft mask in
    crop space (all ones, the whole quad, by default). Crop and mask share one
    warp (the same taps and weights); frame pixels that sample outside the
    crop get zero weight.
    """
    b, hh, ww, _ = frame.shape
    s = swapped_crop.shape[1]
    if mask_crop is None:
        mask_crop = torch.ones((b, s, s, 1), dtype=frame.dtype, device=frame.device)
    nc = swapped_crop.shape[-1]
    sx, sy = _source_coords(coeffs, hh, ww)
    both = grid_sample(torch.cat([swapped_crop, mask_crop.to(swapped_crop.dtype)], dim=-1),
                       torch.stack([sx, sy], dim=-1))
    warped, warped_mask = both[..., :nc], both[..., nc:]
    inside = ((sx >= 0) & (sx <= s - 1) & (sy >= 0) & (sy <= s - 1)).to(frame.dtype)[..., None]
    alpha = warped_mask * inside
    return frame * (1.0 - alpha) + warped * alpha
