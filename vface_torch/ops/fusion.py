"""FSAI / latent fusion primitives: the spectral and statistical blends of VFace.

Port of ``vface_tpu/ops/fusion.py``:

* ``combine_fft_high_low`` (and its circulant form): 1-D FFT split over the
  channel dim, low-frequency bins from the branch, high from the donor;
* ``fft_fusion``: 2-D circular-annulus spectral blend (NHWC);
* ``gaussian_blur``, ``lpf_fusion``: Gaussian low/high-pass blend;
* ``adain_fusion`` (spatial dims), ``adain_fusion_attn`` (channel dim), with
  torch's unbiased std as in the reference;
* ``mix``: linear blend; ``temporal_gaussian``: Gaussian frame window.

For real inputs the 1-D split

    out = Re(ifft(mask * fft(branch) + (1 - mask) * fft(donor)))

is linear and equals ``donor + (branch - donor) @ K_low`` with ``K_low`` the
circulant of ``Re(ifft(mask))``: one (D, D) float32 matrix product instead of
complex FFT round trips. Both forms are here; the circulant one is the default.
All math runs in float32; the layouts are the JAX package's (NHWC, frames on
axis 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def combine_fft_high_low(donor: torch.Tensor, branch: torch.Tensor, split_ratio: float = 0.8):
    """Low-freq bins [0, split) from ``branch``, high-freq bins [split, D) from ``donor``."""
    d = donor.shape[-1]
    split = int(d * split_ratio)
    fd = torch.fft.fft(donor.to(torch.float32), dim=-1)
    fb = torch.fft.fft(branch.to(torch.float32), dim=-1)
    mask = (torch.arange(d, device=donor.device) < split).to(torch.float32)
    combined = fb * mask + fd * (1.0 - mask)
    return torch.fft.ifft(combined, dim=-1).real.to(torch.float32)


@functools.lru_cache(maxsize=32)
def _low_circulant(d: int, split: int) -> np.ndarray:
    """Circulant K with (x @ K) == Re(ifft(mask * fft(x))) for real x; K[m, n] = k[(n-m) % d]."""
    mask = (np.arange(d) < split).astype(np.float64)
    k = np.fft.ifft(mask).real
    idx = (np.arange(d)[None, :] - np.arange(d)[:, None]) % d
    return k[idx].astype(np.float32)


@functools.lru_cache(maxsize=32)
def _low_circulant_on(d: int, split: int, device: torch.device) -> torch.Tensor:
    # made outside inference mode: the cached matrix also serves calls that
    # record a gradient, which an inference tensor cannot take part in
    with torch.inference_mode(False):
        return torch.from_numpy(_low_circulant(d, split)).to(device)


def combine_fft_high_low_circulant(
    donor: torch.Tensor, branch: torch.Tensor, split_ratio: float = 0.8
):
    """Exact matrix-product form of :func:`combine_fft_high_low`:
    ``donor + (branch - donor) @ K_low`` in float32."""
    d = donor.shape[-1]
    split = int(d * split_ratio)
    k_low = _low_circulant_on(d, split, donor.device)
    donor = donor.to(torch.float32)
    branch = branch.to(torch.float32)
    return donor + torch.matmul(branch - donor, k_low)


# ---------------------------------------------------------------- 2-D spectral
def _annulus_mask(h: int, w: int, center: float, center_exclude: float) -> np.ndarray:
    cy, cx = h // 2, w // 2
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    return ((dist <= center) & (dist > center_exclude)).astype(np.float32)


def fft_fusion(noise_a: torch.Tensor, noise_b: torch.Tensor, center: float = 16, center_exclude: float = 3):
    """2-D circular-annulus spectral blend (NHWC): annulus bins from B, the rest
    from A, over the fftshift-centred spectrum of the two spatial dims."""
    h, w = noise_a.shape[1], noise_a.shape[2]
    mask = torch.from_numpy(_annulus_mask(h, w, center, center_exclude)).to(noise_a.device)[None, :, :, None]
    dims = (1, 2)
    fa = torch.fft.fftshift(torch.fft.fft2(noise_a.to(torch.float32), dim=dims), dim=dims)
    fb = torch.fft.fftshift(torch.fft.fft2(noise_b.to(torch.float32), dim=dims), dim=dims)
    combined = fa * (1.0 - mask) + fb * mask
    combined = torch.fft.ifft2(torch.fft.ifftshift(combined, dim=dims), dim=dims)
    return combined.real.to(torch.float32)


# ---------------------------------------------------------- Gaussian low-pass
@functools.lru_cache(maxsize=8)
def _gaussian_kernel2d(kernel_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float32) - kernel_size // 2
    grid = coords[None, :] ** 2 + coords[:, None] ** 2
    kernel = np.exp(-grid / (2 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0):
    """Depthwise Gaussian blur, NHWC, SAME zero padding, float32."""
    c = x.shape[-1]
    k = torch.from_numpy(_gaussian_kernel2d(kernel_size, sigma)).to(x.device)
    lo = (kernel_size - 1) // 2  # SAME: the extra pad of an even kernel goes after
    hi = kernel_size - 1 - lo
    xp = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    out = F.conv2d(xp, k.expand(c, 1, kernel_size, kernel_size), groups=c)
    return out.permute(0, 2, 3, 1)


def lpf_fusion(noise_a: torch.Tensor, noise_b: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0):
    """Structure (low-pass) from A plus identity (high-pass) from B."""
    structure = gaussian_blur(noise_a, kernel_size, sigma)
    identity = noise_b - gaussian_blur(noise_b, kernel_size, sigma)
    return structure + identity


# ----------------------------------------------------------------- AdaIN
def _std_unbiased(x: torch.Tensor, dims) -> torch.Tensor:
    """torch's ``.std()`` (ddof 1) over ``dims``, kept: the JAX package's formula."""
    dims = dims if isinstance(dims, tuple) else (dims,)
    n = int(np.prod([x.shape[d] for d in dims]))
    var = x.var(dim=dims, unbiased=False, keepdim=True) * (n / max(n - 1, 1))
    return torch.sqrt(var)


def adain_fusion(noise_a: torch.Tensor, noise_b: torch.Tensor, alpha: float = 0.71, beta: float = 1.0,
                 normalized: bool = True):
    """AdaIN over the spatial dims, NHWC: structure from A, per-(batch, channel)
    statistics from B, blended with A by ``alpha`` and scaled by ``beta``."""
    dims = (1, 2)
    mean_a = noise_a.mean(dim=dims, keepdim=True)
    std_a = _std_unbiased(noise_a, dims)
    mean_b = noise_b.mean(dim=dims, keepdim=True)
    std_b = _std_unbiased(noise_b, dims)
    normalized_a = (noise_a - mean_a) / (std_a + 1e-5) if normalized else noise_a
    fused = normalized_a * (std_b + 1e-5) + mean_b
    return ((1.0 - alpha) * noise_a + alpha * fused) * beta


def adain_fusion_attn(noise_a: torch.Tensor, noise_b: torch.Tensor, alpha: float = 0.71,
                      normalized: bool = True):
    """AdaIN over the last (channel) dim for attention q/k. ``normalized``:
    renormalise by the global std of the fused tensor; else scale by ``alpha``
    (alpha only scales the un-normalised branch, as in the reference)."""
    mean_a = noise_a.mean(dim=-1, keepdim=True)
    std_a = _std_unbiased(noise_a, -1)
    mean_b = noise_b.mean(dim=-1, keepdim=True)
    std_b = _std_unbiased(noise_b, -1)
    fused = (noise_a - mean_a) / (std_a + 1e-5) * std_b + mean_b
    if normalized:
        n = fused.numel()
        gstd = torch.sqrt(fused.var(unbiased=False) * (n / max(n - 1, 1)))
        return fused / (gstd + 1e-5)
    return alpha * fused


def mix(target: torch.Tensor, source: torch.Tensor, alpha: float = 0.5):
    """(1 - alpha) * source + alpha * target."""
    return (1.0 - alpha) * source + alpha * target


# ------------------------------------------------------- temporal Gaussian
@functools.lru_cache(maxsize=8)
def _temporal_weights(t: int, window_size: int, sigma: float) -> np.ndarray:
    """(T, T) row-normalised Gaussian band matrix."""
    pad = window_size // 2
    offsets = np.arange(-pad, pad + 1, dtype=np.float32)
    gauss = np.exp(-0.5 * (offsets / sigma) ** 2)
    gauss = gauss / gauss.sum()
    w = np.zeros((t, t), dtype=np.float32)
    for ti in range(t):
        for i, off in enumerate(offsets):
            idx = ti + int(off)
            if 0 <= idx < t:
                w[ti, idx] = gauss[i]
    return w / w.sum(axis=1, keepdims=True)


def temporal_gaussian(x: torch.Tensor, window_size: int = 5, sigma: float = 1.0):
    """Gaussian-weighted frame average along axis 0: one (T, T) float32 product."""
    t = x.shape[0]
    w = torch.from_numpy(_temporal_weights(t, window_size, sigma)).to(x.device)
    return torch.einsum("ts,s...->t...", w, x.to(torch.float32))
