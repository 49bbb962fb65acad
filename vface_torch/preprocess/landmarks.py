"""68-point facial landmarks, batched on the device (the dlib replacement).

Port of ``vface_tpu/preprocess/landmarks.py``: :class:`LandmarkNet` (a small
fully convolutional heatmap regressor at a canonical 256^2 detection scale),
its shape-constrained decode :func:`decode_heatmaps`, :func:`landmarks_to_vector`
and :func:`load_default_landmark_params`, which reads the JAX package's shipped
weights, ``vface_tpu/weights/landmark_net.npz``, as a data file (a flat npz of
the Flax tree, ``"conv_0/kernel"`` and so on); and :class:`UNetLandmarkHead`,
the training landmark loss's head over UNet features.

Conventions that differ between Flax and PyTorch, held here to the JAX
package's: the resize to the detection scale is bilinear with antialiasing
when it downsamples; ``std`` is the population statistic; GroupNorm uses
eps 1e-6.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn as nn

from vface_torch.models.layers import Conv, Dense, GroupNorm32
from vface_torch.ops.warp import resize_bilinear
from vface_torch.runtime.checkpoint import read_flat_npz
from vface_torch.preprocess.synthetic_faces import canonical_landmarks

DEFAULT_WEIGHTS_PATH = Path(__file__).resolve().parents[2] / "vface_tpu" / "weights" / "landmark_net.npz"


class LandmarkNet(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (B, 68, 2) pixel coordinates (x, y) in the input's scale.

    The image is resized to ``detect_size``^2 and reduced to a
    photometric-invariant featurisation (standardised grey plus its x and y
    gradients); six 3x3 conv + GroupNorm + ReLU stages (three of stride 2) and
    two dilated context convs give 68 heatmaps at 1/8 scale, which
    :func:`decode_heatmaps` turns into points.
    """

    def __init__(self, width: int = 32, detect_size: int = 256):
        super().__init__()
        self.detect_size = detect_size
        w = width
        chans = [(3, w, 2), (w, 2 * w, 1), (2 * w, 2 * w, 2), (2 * w, 4 * w, 1), (4 * w, 4 * w, 2), (4 * w, 8 * w, 1)]
        for i, (ci, co, stride) in enumerate(chans):
            self.add_module(f"conv_{i}", Conv(ci, co, kernel=3, stride=stride, padding=1))
            self.add_module(f"gn_{i}", GroupNorm32(co, eps=1e-6, num_groups=8))
        for i, dil in enumerate((2, 4)):
            self.add_module(f"ctx_{i}", Conv(8 * w, 8 * w, kernel=3, padding=dil, dilation=dil))
            self.add_module(f"ctx_gn_{i}", GroupNorm32(8 * w, eps=1e-6, num_groups=8))
        self.head = Conv(8 * w, 68, kernel=1)
        self.n_stages = len(chans)

    def heatmaps(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> heatmap logits (B, d/8, d/8, 68) in detection space."""
        h = photometric_features(x, self.detect_size)
        for i in range(self.n_stages):
            h = torch.relu(getattr(self, f"gn_{i}")(getattr(self, f"conv_{i}")(h)))
        for i in range(2):
            h = torch.relu(getattr(self, f"ctx_gn_{i}")(getattr(self, f"ctx_{i}")(h)))
        return self.head(h).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_h, in_w = x.shape[1], x.shape[2]
        heat = self.heatmaps(x)
        hh, ww = heat.shape[1], heat.shape[2]
        scale = torch.tensor([in_w / ww, in_h / hh], dtype=torch.float32, device=x.device)
        return decode_heatmaps(heat) * scale


def photometric_features(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, 3, size, size): the grey image resized to
    size^2, standardised per image, and its x and y forward differences (the
    landmark net's and the face detector's photometric-invariant input)."""
    if tuple(x.shape[1:3]) != (size, size):
        x = resize_bilinear(x, size, size)
    g = x.to(torch.float32).mean(dim=-1, keepdim=True)
    mu = g.mean(dim=(1, 2, 3), keepdim=True)
    sd = g.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-5
    g = (g - mu) / sd
    gx = torch.nn.functional.pad(g[:, :, 1:] - g[:, :, :-1], (0, 0, 0, 1))
    gy = torch.nn.functional.pad(g[:, 1:] - g[:, :-1], (0, 0, 0, 0, 0, 1))
    return torch.cat([g, gx, gy], dim=-1).permute(0, 3, 1, 2)


def _local_soft_argmax(flat, ix, iy, xx, yy):
    """3x3 local soft-argmax around the (ix, iy) cells -> (B, K) x and y."""
    near = ((yy - iy[:, None, :]).abs() <= 1.0) & ((xx - ix[:, None, :]).abs() <= 1.0)
    prob = torch.softmax(torch.where(near, flat, -torch.inf), dim=1)
    return (prob * xx).sum(dim=1), (prob * yy).sum(dim=1)


def _fit_similarity(canon, pts, wgt):
    """Weighted similarity fit canon -> pts (rotation, scale, translation;
    Umeyama with a reflection guard). canon (K, 2); pts (B, K, 2); wgt (B, K).
    Returns (A (B, 2, 2), t (B, 2))."""
    wsum = wgt.sum(dim=1, keepdim=True) + 1e-6
    mu_p = (wgt[..., None] * pts).sum(dim=1) / wsum
    mu_c = (wgt[..., None] * canon[None]).sum(dim=1) / wsum
    pc = pts - mu_p[:, None]
    cc = canon[None] - mu_c[:, None]
    cov = torch.einsum("bk,bki,bkj->bij", wgt, pc, cc) / wsum[..., None]
    var_c = (wgt[..., None] * cc**2).sum(dim=(1, 2)) / wsum[:, 0] + 1e-8
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.sign(det)], dim=-1)  # rotation only
    r = torch.einsum("bij,bj,bjk->bik", u, d, vt)
    scale = (s * d).sum(dim=-1) / var_c
    a = scale[:, None, None] * r
    t = mu_p - torch.einsum("bij,bj->bi", a, mu_c)
    return a, t


def decode_heatmaps(heat: torch.Tensor) -> torch.Tensor:
    """Heatmap logits (B, h, w, 68) -> (B, 68, 2) grid coordinates (x, y).

    1. per channel, the global argmax as a candidate and its channel-softmax
       peak mass as its confidence;
    2. a confidence-weighted similarity fit of the canonical 68-point layout
       to the candidates;
    3. per channel, the argmax gated to a radius around the fitted layout's
       point, twice (refitting after the first gated pass);
    4. a 3x3 local soft-argmax around the final cell.
    """
    b, h, w, k = heat.shape
    dev = heat.device
    flat = heat.reshape(b, h * w, k).to(torch.float32)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    yy, xx = yy.reshape(1, -1, 1), xx.reshape(1, -1, 1)
    canon = torch.from_numpy(canonical_landmarks()).to(dev)

    prob_g = torch.softmax(flat, dim=1)
    idx = flat.argmax(dim=1)
    cand = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    wgt = prob_g.amax(dim=1)
    for _ in range(2):
        a, t = _fit_similarity(canon, cand, wgt)
        exp_pt = torch.einsum("bij,kj->bki", a, canon) + t[:, None]
        s_face = torch.sqrt(torch.linalg.det(a).abs())[:, None, None]
        r_gate = torch.clamp(0.45 * s_face, min=1.5)
        d2 = (xx - exp_pt[:, None, :, 0]) ** 2 + (yy - exp_pt[:, None, :, 1]) ** 2
        idx = torch.where(d2 <= r_gate**2, flat, -torch.inf).argmax(dim=1)
        ix, iy = (idx % w).to(torch.float32), (idx // w).to(torch.float32)
        cand = torch.stack([ix, iy], dim=-1)
        wgt = torch.gather(prob_g, 1, idx[:, None, :])[:, 0, :]
    gx, gy = _local_soft_argmax(flat, ix, iy, xx, yy)
    return torch.stack([gx, gy], dim=-1)


class UNetLandmarkHead(nn.Module):
    """(B, S, S, in_channels) UNet features -> (B, 136) landmark coordinates, in
    float32: a 3x3 conv to 128 channels, ReLU, a 2x2 max-pool, the NCHW flatten
    (torch's order, as the JAX head flattens) and a dense layer. ``size`` is S,
    the features' side, which fixes the dense layer's width."""

    def __init__(self, in_channels: int, size: int):
        super().__init__()
        self.conv = Conv(in_channels, 128)
        self.fc = Dense(128 * (size // 2) ** 2, 136)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv(feats.to(torch.float32).permute(0, 3, 1, 2)))
        x = torch.nn.functional.max_pool2d(x, 2, 2)
        return self.fc(x.reshape(x.shape[0], -1))


def landmarks_to_vector(landmarks68: torch.Tensor) -> torch.Tensor:
    """(B, 68, 2) -> (B, 136) in the x, y interleaved order of the conditioning."""
    return landmarks68.reshape(landmarks68.shape[0], 136)


def load_default_landmark_params(path=DEFAULT_WEIGHTS_PATH):
    """The shipped LandmarkNet weights as a Flax-style tree (nested dicts of
    numpy arrays, for :func:`vface_torch.utils.convert.from_flax_aux`), or None
    when the file is absent."""
    path = Path(path)
    return read_flat_npz(path) if path.exists() else None

