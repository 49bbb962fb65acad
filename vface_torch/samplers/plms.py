"""PLMS sampling (pseudo linear multistep), the image path's alternative to DDIM.

Port of ``vface_tpu/samplers/plms.py``: CFG over the 2-chunk [uncond, cond]
batch, then an Adams-Bashforth step over the epsilon predictions with the
standard PLMS warm-up:

    k = 0 : Heun: step with e_t, re-evaluate at x', use (e_t + e') / 2
    k = 1 : (3 e_t - e_-1) / 2
    k = 2 : (23 e_t - 16 e_-1 + 5 e_-2) / 12
    k >= 3: (55 e_t - 59 e_-1 + 37 e_-2 - 9 e_-3) / 24

The old epsilons are a newest-first list of at most three. The Heun
candidate's eval runs at k = 0 only, where it is used: the JAX scan evaluates
it at every step and its select discards it after the first, so the result
is the same with one eval a step fewer from k = 1 on.
"""

from __future__ import annotations

import torch

from vface_torch.utils.schedule import DDIMSchedule


def plms_sample(model, x_T, cond, uncond, inpaint_latent, mask_latent, num_steps: int = 50,
                cfg_scale: float = 3.0):
    """PLMS from x_T (B, h, w, 4) -> (z_0, pred_x0 trajectory (S, B, h, w, 4)).

    ``inpaint_latent`` (B, h, w, 4) and ``mask_latent`` (B, h, w, 1) are the
    fixed inpainting channels; S is the schedule's step count, which may
    exceed ``num_steps`` where it does not divide the timesteps.
    """
    sch = DDIMSchedule.create(model.schedule, num_steps)
    n = sch.num_steps
    b = x_T.shape[0]
    dev = x_T.device
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    c_in = torch.cat([uncond, cond], dim=0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)

    def eps_at(x, index):
        x9 = torch.cat([x, extra], dim=-1)
        t = torch.full((2 * b,), int(sch.timesteps[index]), dtype=torch.int64, device=dev)
        eps = model.apply_model(torch.cat([x9, x9], dim=0), t, c_in)
        return eps[:b] + cfg_scale * (eps[b:] - eps[:b])

    def x_prev_from(x, e, index):
        a_t, a_prev = f32(sch.alphas[index]), f32(sch.alphas_prev[index])
        pred_x0 = (x - f32(sch.sqrt_one_minus_alphas[index]) * e) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e
        return torch.sqrt(a_prev) * pred_x0 + dir_xt, pred_x0

    x = x_T.to(torch.float32)
    old, traj = [], []
    for idx in range(n):
        index = n - 1 - idx
        e_t = eps_at(x, index)
        if idx == 0:
            x1, _ = x_prev_from(x, e_t, index)
            e_prime = 0.5 * (e_t + eps_at(x1, max(index - 1, 0)))
        elif idx == 1:
            e_prime = (3.0 * e_t - old[0]) / 2.0
        elif idx == 2:
            e_prime = (23.0 * e_t - 16.0 * old[0] + 5.0 * old[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * old[0] + 37.0 * old[1] - 9.0 * old[2]) / 24.0
        x, pred_x0 = x_prev_from(x, e_prime, index)
        old = [e_t] + old[:2]
        traj.append(pred_x0)
    return x, torch.stack(traj)
