"""Flow warping for FGATS: bilinear grid sampling and frame alignment, NHWC, float32.

Port of ``vface_tpu/ops/warp.py``'s ``grid_sample`` (the wide-channel
four-gather form), ``warp_by_flow``, ``resize_flow`` and ``align_by_flow``.
Flow is in pixel units with channels (dx, dy); ``flow[i]`` maps frame i+1's
pixels back to frame i.
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


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC x, as ``jax.image.resize(..., "bilinear")``.

    ``antialias=True`` matters: JAX widens the kernel when it downsamples
    (512 -> 64 on the main path); without it the two differ by up to 0.47 on a
    mask edge.
    """
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def resize_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinearly resize a flow field (B, H, W, 2) and rescale its displacements."""
    _, h, w, _ = flow.shape
    scale = torch.tensor([width / w, height / h], dtype=flow.dtype, device=flow.device)
    return resize_bilinear(flow, height, width) * scale


def align_by_flow(
    x: torch.Tensor, flow: torch.Tensor, alpha: float = 0.8, pair_mask: torch.Tensor = None
) -> torch.Tensor:
    """FGATS blend over the frame (batch) axis.

    x: (F, H, W, C); flow: (F-1, H, W, 2). out[0] = x[0] and
    out[i+1] = alpha * x[i+1] + (1 - alpha) * warp(x[i], flow[i]).
    ``pair_mask`` (F-1,) disables the blend where it is 0 (out[i+1] = x[i+1]).
    """
    warped_prev = warp_by_flow(x[:-1], flow)
    blended = alpha * x[1:] + (1.0 - alpha) * warped_prev
    if pair_mask is not None:
        m = pair_mask.to(blended.dtype)[:, None, None, None]
        blended = m * blended + (1.0 - m) * x[1:]
    return torch.cat([x[:1], blended.to(x.dtype)], dim=0)
