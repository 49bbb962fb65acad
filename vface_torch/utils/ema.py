"""Exponential moving average of parameters (port of ``vface_tpu/utils/ema.py``).

The reference's LitEma: the decay warms up as ``min(decay, (1 + n) / (10 + n))``
with n the number of updates so far (counted from 1), and the average is a
parallel ``{name: tensor}`` dict updated in place. Swap the average into a
model with ``model.load_state_dict`` (see
:func:`vface_torch.pipelines.train_driver.validate`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class EmaState(NamedTuple):
    params: Dict[str, torch.Tensor]
    updates: int


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """A detached copy of ``params`` and an update count of 0."""
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0)


@torch.no_grad()
def ema_update(state: EmaState, new_params: Dict[str, torch.Tensor], decay: float = 0.9999) -> EmaState:
    """``ema = ema * d + new * (1 - d)`` in place over every floating entry, with
    ``d = min(decay, (1 + n) / (10 + n))`` in float32 as JAX computes it."""
    n = state.updates + 1
    f32 = np.float32
    d = min(f32(decay), (f32(1) + f32(n)) / (f32(10) + f32(n)))
    keys = [k for k, v in state.params.items() if v.is_floating_point()]
    ema = [state.params[k] for k in keys]
    new = [new_params[k].to(state.params[k].dtype) for k in keys]
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(new, float(f32(1) - d)))
    return EmaState(state.params, n)
