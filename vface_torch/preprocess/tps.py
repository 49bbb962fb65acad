"""Batched thin-plate-spline warp: the training masks' "decow" deformation.

Port of ``vface_tpu/preprocess/tps.py`` (the reference's ``thinplatespline``
``TPS_coeffs``/``TPS``): one (N+3) x (N+3) solve per batch element for the
spline through the control points, then the dense warp grid as one batched
product, sampled bilinearly. Control points are in normalised [-1, 1]
coordinates, (x, y). The solve and the grid run in float32, as the JAX
package's do.
"""

from __future__ import annotations

import torch

from vface_torch.ops.warp import grid_sample


def _u(r2: torch.Tensor) -> torch.Tensor:
    """The TPS radial basis U(r) = r^2 log r^2, with U(0) = 0."""
    return torch.where(r2 == 0, torch.zeros_like(r2), r2 * torch.log(torch.clamp(r2, min=1e-12)))


def tps_coefficients(src: torch.Tensor, dst: torch.Tensor):
    """The TPS mapping control points ``src`` to ``dst``, each (B, N, 2).

    Returns (w, a): the radial weights (B, N, 2) and the affine part (B, 3, 2).
    """
    src, dst = src.to(torch.float32), dst.to(torch.float32)
    b, n, _ = src.shape
    d2 = ((src[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1)
    k = _u(d2)
    p = torch.cat([torch.ones((b, n, 1), device=src.device), src], dim=-1)
    top = torch.cat([k, p], dim=-1)
    bot = torch.cat([p.transpose(1, 2), torch.zeros((b, 3, 3), device=src.device)], dim=-1)
    lhs = torch.cat([top, bot], dim=1)
    rhs = torch.cat([dst, torch.zeros((b, 3, 2), device=src.device)], dim=1)
    sol = torch.linalg.solve(lhs, rhs)
    return sol[:, :n], sol[:, n:]


def tps_transform(points: torch.Tensor, src: torch.Tensor, w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The TPS at ``points`` (B, M, 2): its affine part plus its radial terms."""
    d2 = ((points[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1)
    rad = torch.einsum("bmn,bnd->bmd", _u(d2), w)
    ones = torch.ones(points.shape[:-1] + (1,), device=points.device)
    return rad + torch.einsum("bmk,bkd->bmd", torch.cat([ones, points], dim=-1), a)


def tps_warp(img: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` (B, H, W, C) so that the ``dst`` control points land on the
    ``src`` positions: each output pixel's source is the TPS fitted from dst to
    src at that pixel, sampled bilinearly (edge-clamped)."""
    b, h, w_, _ = img.shape
    dev = img.device
    wgt, aff = tps_coefficients(dst, src)
    yy, xx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev), torch.linspace(-1.0, 1.0, w_, device=dev),
                            indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)[None].expand(b, h * w_, 2)
    mapped = tps_transform(pts, dst.to(torch.float32), wgt, aff)
    px = (mapped[..., 0] + 1.0) * 0.5 * (w_ - 1)
    py = (mapped[..., 1] + 1.0) * 0.5 * (h - 1)
    return grid_sample(img, torch.stack([px, py], dim=-1).reshape(b, h, w_, 2))
