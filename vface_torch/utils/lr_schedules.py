"""LR multiplier schedules (port of ``vface_tpu/utils/lr_schedules.py``).

``LambdaLinearScheduler`` of the reference training config, cycle 0: a linear
warm-up from ``f_start`` to ``f_max`` over ``warm_up_steps``, then a linear
decay toward ``f_min`` over an effectively infinite cycle (1.0 after warm-up
at the shipped settings); and ``LambdaWarmUpCosineScheduler2``, cycle 0: the
same warm-up, then a half cosine from ``f_max`` to ``f_min`` ending at
``cycle_length``. Each returns ``schedule(step) -> multiplier`` for
``torch.optim.lr_scheduler.LambdaLR``; the arithmetic is float32, as the JAX
version's.
"""

from __future__ import annotations

import numpy as np


def lambda_linear_schedule(
    warm_up_steps: int = 10_000,
    f_start: float = 1e-6,
    f_max: float = 1.0,
    f_min: float = 1.0,
    cycle_length: float = 1e13,
):
    """LambdaLinearScheduler (reference ``lr_scheduler.py``), cycle 0."""
    f32 = np.float32

    def schedule(n) -> float:
        n = f32(n)
        if n < warm_up_steps:
            return float(f32((f_max - f_start) / warm_up_steps) * n + f32(f_start))
        return float(f32(f_min) + f32(f_max - f_min) * (f32(cycle_length) - n) / f32(cycle_length))

    return schedule


def lambda_warmup_cosine_schedule(
    warm_up_steps: int,
    f_start: float,
    f_max: float,
    f_min: float,
    cycle_length: int,
):
    """LambdaWarmUpCosineScheduler2 (reference ``lr_scheduler.py``), cycle 0."""
    f32 = np.float32

    def schedule(n) -> float:
        n = f32(n)
        if n < warm_up_steps:
            return float(f32((f_max - f_start) / warm_up_steps) * n + f32(f_start))
        t = np.clip((n - f32(warm_up_steps)) / f32(cycle_length - warm_up_steps), f32(0), f32(1))
        return float(f32(f_min) + f32(0.5 * (f_max - f_min)) * (f32(1) + np.cos(t * f32(np.pi))))

    return schedule
