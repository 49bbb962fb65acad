"""The one traffic generator: seeded synthetic faces on the device.

Every input is drawn from a ``torch.Generator`` seeded with a call's seed, so
the same seed gives the same clip or pairs, and every seed gives the same
sizes. A traffic file (``traffic/<name>.json``) sets the sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.clip import clip_preprocess
from benchmark.reference.landmarks import canonical_landmarks


def call_seed(seed: int, index: int) -> int:
    """The seed of call ``index`` of a run with ``seed`` (any size; 63 bits kept)."""
    return (int(seed) * 1_000_003 + 7919 * index + 1) % (2**63 - 1)


def _faces(g, frames: int, h: int, w: int, device, drift: float):
    """A cartoon face over a smooth background, (frames, h, w, 3) in [0, 1],
    drifting ``drift`` pixels a frame and turning slightly, and its
    per-frame (centre x, centre y, radius, angle)."""
    u01 = lambda *s: torch.rand(s, generator=g, device=device)
    bg = torch.nn.functional.interpolate(u01(1, 3, 9, 16), size=(h, w), mode="bilinear")
    bg = bg.permute(0, 2, 3, 1)[0] * 0.6 + 0.2
    skin = u01(3) * 0.3 + torch.tensor([0.6, 0.45, 0.35], device=device)
    jit = u01(4).tolist()
    cx0, cy0 = w * (0.42 + 0.16 * jit[0]), h * (0.45 + 0.1 * jit[1])
    r0, turn = h * (0.25 + 0.06 * jit[2]), 0.04 * (jit[3] - 0.5)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    blobs = [((0.0, -0.55, 0.85, 0.55), torch.tensor([0.15, 0.1, 0.08], device=device)),  # hair
             ((0.0, 0.0, 0.72, 0.95), skin),  # face
             ((-0.3, -0.22, 0.12, 0.06), torch.tensor([0.1, 0.1, 0.12], device=device)),  # eyes
             ((0.3, -0.22, 0.12, 0.06), torch.tensor([0.1, 0.1, 0.12], device=device)),
             ((0.0, 0.12, 0.06, 0.12), skin * 0.8),  # nose
             ((0.0, 0.45, 0.25, 0.07), torch.tensor([0.6, 0.2, 0.2], device=device))]  # mouth
    out, poses = [], []
    for i in range(frames):
        cx, cy, r, ang = cx0 + drift * i, cy0 + drift * i / 3, r0 * (1 + 0.01 * i), turn * i
        u = ((xx - cx) * math.cos(ang) + (yy - cy) * math.sin(ang)) / r
        v = (-(xx - cx) * math.sin(ang) + (yy - cy) * math.cos(ang)) / r
        img = bg.clone()
        for (ex, ey, rx, ry), col in blobs:
            q = ((u - ex) / rx) ** 2 + ((v - ey) / ry) ** 2
            a = torch.clamp((1.0 - q) / 0.15, 0.0, 1.0)[..., None]
            img = img + a * (col - img)
        out.append(img)
        poses.append((cx, cy, r, ang))
    return torch.stack(out).clamp(0.0, 1.0), poses


def video_clip(traffic: dict, seed: int, device) -> dict:
    """One call's inputs: ``frames`` (N, H, W, 3) and ``source`` (H, W, 3), in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = traffic["height"], traffic["width"]
    frames, _ = _faces(g, traffic["frames"], h, w, device, traffic["drift_px"])
    source, _ = _faces(g, 1, h, w, device, 0.0)
    return {"frames": frames, "source": source[0]}


def _landmarks(pose) -> np.ndarray:
    """The canonical 68-point layout placed on a face's pose, (68, 2) pixels."""
    cx, cy, r, ang = pose
    p = canonical_landmarks() * np.float32(r * 0.8)
    c, s = math.cos(ang), math.sin(ang)
    return np.stack([cx + c * p[:, 0] - s * p[:, 1], cy + s * p[:, 0] + c * p[:, 1]], axis=-1).astype(np.float32)


def _keep(lm: np.ndarray, size: int, device) -> torch.Tensor:
    """1 outside an ellipse over the landmarks' box, (size, size, 1)."""
    (x0, y0), (x1, y1) = lm.min(axis=0), lm.max(axis=0)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32), indexing="ij")
    face = (((xx - (x0 + x1) / 2) / (0.6 * (x1 - x0) + 1)) ** 2
            + ((yy - (y0 + y1) / 2) / (0.6 * (y1 - y0) + 1)) ** 2) <= 1.0
    return (~face).to(torch.float32)[..., None]


def image_pairs(traffic: dict, seed: int, size: int, latent: int, clip_size: int, device) -> dict:
    """One call's inputs for ``pairs`` swaps at ``size``^2: target crops in [-1, 1],
    keep-masks, the masked sources CLIP-normalised, the sources in [0, 1], the
    targets' landmarks (B, 136) and the sampler's start noise x_T at the
    latent size (B, latent, latent, 4)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = traffic["pairs"]
    tar, src, lms, tar_keep, src_keep = [], [], [], [], []
    for _ in range(n):
        t, tp = _faces(g, 1, size, size, device, 0.0)
        s, sp = _faces(g, 1, size, size, device, 0.0)
        tl, sl = _landmarks(tp[0]), _landmarks(sp[0])
        tar.append(t[0])
        src.append(s[0])
        lms.append(torch.from_numpy(tl.reshape(136)).to(device))
        tar_keep.append(_keep(tl, size, device))
        src_keep.append(_keep(sl, size, device))
    src01, src_keep = torch.stack(src), torch.stack(src_keep)
    x_t = torch.randn((n, latent, latent, 4), generator=g, device=device)
    return {"target": torch.stack(tar) * 2 - 1, "keep": torch.stack(tar_keep),
            "src_clip": clip_preprocess(src01 * (1 - src_keep), clip_size), "src01": src01,
            "landmarks": torch.stack(lms), "x_T": x_t}
