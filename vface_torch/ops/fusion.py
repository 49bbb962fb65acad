"""FSAI channel-spectrum fusion: low-frequency bins from the branch, high from the donor.

Port of the 1-D FFT split of ``vface_tpu/ops/fusion.py``. For real inputs

    out = Re(ifft(mask * fft(branch) + (1 - mask) * fft(donor)))

is linear and equals ``donor + (branch - donor) @ K_low`` with ``K_low`` the
circulant of ``Re(ifft(mask))``: one (D, D) float32 matrix product instead of
complex FFT round trips. Both forms are here; the circulant one is the default.
All math runs in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
