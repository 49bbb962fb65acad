"""Exact ``F.adaptive_avg_pool2d`` windows on NHWC tensors, as two small matmuls.

Port of ``vface_tpu/ops/pooling.py`` with its own copy of the box-window
matrices: output bin i averages input window [floor(i*In/Out),
ceil((i+1)*In/Out)), a box filter when downsampling and a nearest repeat when
upsampling. Used by the ArcFace preprocessing of the ID loss.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic matrix of 1-D adaptive average pooling."""
    idx = np.arange(out_size, dtype=np.int64)
    starts = (idx * in_size) // out_size
    ends = -((-(idx + 1) * in_size) // out_size)  # ceil((i+1)*In/Out)
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        w[i, starts[i] : ends[i]] = 1.0 / float(ends[i] - starts[i])
    return w


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC adaptive average pool with exact ``F.adaptive_avg_pool2d`` windows."""
    wh = torch.from_numpy(_adaptive_matrix(x.shape[1], out_h)).to(x.device, x.dtype)
    ww = torch.from_numpy(_adaptive_matrix(x.shape[2], out_w)).to(x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bowc->bopc", ww, y)
