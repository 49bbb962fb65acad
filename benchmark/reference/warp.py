"""The benchmark reference's frozen copy of ``vface_torch/ops/warp.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

Flow warping for FGATS: bilinear grid sampling and frame alignment, NHWC, float32.

Port of ``vface_tpu/ops/warp.py``: ``grid_sample``, ``warp_by_flow``,
``resize_flow``, ``align_by_flow`` (with the cross-window ``prev0``/``flow0``
and ``pair_mask``), the recurrent ``align_by_flow_chain``, the pixel-space
``align_by_flow_high_res`` and ``batch_flow_align``, ``batch_flow_align_latent``
and ``warp_from_video``. Flow is in pixel units with channels (dx, dy);
``flow[i]`` maps frame i+1's pixels back to frame i.

``grid_sample`` keeps one path, the four row gathers: JAX's small-C form (one
gather over an edge-replicated 4-tap channel stack) is a TPU gather trick
with bit-identical taps. ``align_by_flow_halo`` is the blend on frames
sharded over ranks (the 1-frame halo from the left neighbour).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``img`` (B, H, W, C) at absolute pixel coords (B, Ho, Wo, 2).

    coords[..., 0] = x (width index), coords[..., 1] = y (height index);
    align_corners=True semantics with the coordinates clamped into the image
    (border padding). Four row gathers over the flattened (H·W, C) image.
    """
    b, h, w, c = img.shape
    x = coords[..., 0].to(torch.float32).clamp(0, w - 1)
    y = coords[..., 1].to(torch.float32).clamp(0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    flat = img.reshape(b, h * w, c)

    def take(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(x.shape + (c,))

    v00, v01 = take(y0i, x0i), take(y0i, x1i)
    v10, v11 = take(y1i, x0i), take(y1i, x1i)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` (B, H, W, C) by ``flow`` (B, H, W, 2) in pixel units (dx, dy)."""
    _, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij",
    )
    base = torch.stack([xs, ys], dim=-1)[None]
    return grid_sample(img, base + flow)


def resize_bilinear(x: torch.Tensor, height: int, width: int, antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC x, as ``jax.image.resize(..., "bilinear", antialias=...)``.

    ``antialias=True`` (JAX's default) matters: JAX widens the kernel when it
    downsamples (512 -> 64 on the swap path); without it the two differ by up
    to 0.47 on a mask edge. The training loss resizes with ``antialias=False``,
    as the reference's torchvision resize does.
    """
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest resize of the two axes after the batch axis ((B, H, W) or NHWC),
    as ``jax.image.resize(..., "nearest")``: output pixel i takes source pixel
    floor((i + 0.5) * in / out) (half-pixel centres, ``F.interpolate``'s
    "nearest-exact"). Any dtype, class maps included."""
    h, w = x.shape[1], x.shape[2]
    src = lambda n_in, n_out: torch.floor(
        (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out).long()
    return x[:, src(h, height)][:, :, src(w, width)]


def resize_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinearly resize a flow field (B, H, W, 2) and rescale its displacements."""
    _, h, w, _ = flow.shape
    scale = torch.tensor([width / w, height / h], dtype=flow.dtype, device=flow.device)
    return resize_bilinear(flow, height, width) * scale


def align_by_flow(x: torch.Tensor, flow: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """FGATS blend over the frame (batch) axis: x (F, H, W, C), flow (F-1, H, W, 2);
    out[0] = x[0], out[i+1] = alpha * x[i+1] + (1 - alpha) * warp(x[i], flow[i])."""
    blended = alpha * x[1:] + (1.0 - alpha) * warp_by_flow(x[:-1], flow)
    return torch.cat([x[:1], blended.to(x.dtype)], dim=0)
