"""The DDIM update (port of ``vface_tpu/samplers/ddim.py::ddim_step``).

    pred_x0 = (x - sqrt(1 - a_t) * e_t) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma^2) * e_t
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise
"""

from __future__ import annotations

from typing import Optional

import torch


def ddim_step(x, e_t, a_t: float, a_prev: float, sqrt_1m_at: float, sigma: float,
              noise: Optional[torch.Tensor] = None):
    """One DDIM update in float32; ``noise=None`` drops the stochastic term (eta = 0).

    The schedule scalars are float32 table entries; the square roots are taken
    in float32 like the JAX version's.
    """
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    a_t, a_prev, sqrt_1m_at, sigma = f32(a_t), f32(a_prev), f32(sqrt_1m_at), f32(sigma)
    pred_x0 = (x - sqrt_1m_at * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma * noise
    return x_prev, pred_x0

