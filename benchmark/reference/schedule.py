"""The benchmark reference's frozen copy of ``vface_torch/utils/schedule.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

Diffusion noise schedules and DDIM timestep tables (numpy, evaluated once).

The port's own copy of ``vface_tpu/utils/schedule.py``: linear / cosine /
sqrt beta schedules, the cumulative-alpha tables, DDIM sub-sequence selection
and the (sigma, alpha, alpha_prev) triplets of Song et al. (arXiv:2010.02502),
plus the custom inversion alpha pairs. The tables are bit-identical to the JAX
package's; only :func:`timestep_embedding` touches torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

Schedule = Literal["linear", "cosine", "sqrt_linear", "sqrt"]


def make_beta_schedule(
    schedule: Schedule = "linear",
    n_timestep: int = 1000,
    linear_start: float = 0.00085,
    linear_end: float = 0.0120,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule table, float64 for accuracy (cast later)."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(
    num_ddim_timesteps: int,
    num_ddpm_timesteps: int = 1000,
    method: Literal["uniform", "quad"] = "uniform",
) -> np.ndarray:
    """DDIM timestep subsequence (ascending), +1 shifted.

    ``uniform`` with S=50, T=1000 yields [1, 21, ..., 961, 981]. The shift is
    clamped to T-1 for step counts that do not divide T.
    """
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(method)
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Full DDPM alpha/sigma tables (length = num_timesteps), float32."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(
        cls,
        schedule: Schedule = "linear",
        timesteps: int = 1000,
        linear_start: float = 0.00085,
        linear_end: float = 0.0120,
        cosine_s: float = 8e-3,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end, cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        f32 = lambda a: a.astype(np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """DDIM sub-schedule derived from a :class:`DiffusionSchedule`.

    Besides the sampling triplets it holds the inversion alpha pairs:

      inv_alpha_next[i] = alphas_cumprod[timesteps[i]]
      inv_alpha_cur[i]  = alphas_cumprod[max(0, timesteps[i] - T//S)]
    """

    timesteps: np.ndarray  # ascending, shape (S,)
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    inv_alpha_next: np.ndarray
    inv_alpha_cur: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @classmethod
    def create(
        cls,
        base: DiffusionSchedule,
        num_steps: int,
        eta: float = 0.0,
        method: Literal["uniform", "quad"] = "uniform",
    ) -> "DDIMSchedule":
        ts = make_ddim_timesteps(num_steps, base.num_timesteps, method)
        acp = base.alphas_cumprod.astype(np.float64)
        alphas = acp[ts]
        alphas_prev = np.concatenate([[float(acp[0])], acp[ts[:-1]]])
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
        stride = base.num_timesteps // len(ts)
        cur_ts = np.maximum(0, ts - stride)
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            timesteps=np.asarray(ts, dtype=np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            sigmas=f32(sigmas),
            inv_alpha_next=f32(acp[ts]),
            inv_alpha_cur=f32(acp[cur_ts]),
        )


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order; (B,) → (B, dim) float32."""
    half = dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
