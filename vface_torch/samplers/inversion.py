"""DDIM inversion with the latent stack kept on the device.

Port of ``vface_tpu/samplers/inversion.py::ddim_invert`` without CFG and the
encoder cache: an ascending pass over the DDIM timesteps with the custom
alpha indexing

    alpha_next = alphas_cumprod[step]
    alpha_cur  = alphas_cumprod[max(0, step - T // S)]
    x <- (x - sqrt(1 - alpha_cur) e_t) sqrt(alpha_next / alpha_cur) + sqrt(1 - alpha_next) e_t

The JAX ``lax.scan`` is a Python loop here. Hooks are off during inversion,
so the UNet runs without injection.
"""

from __future__ import annotations

from typing import Optional

import torch

from vface_torch.utils.schedule import DDIMSchedule


def ddim_invert(model, z0, cond, inpaint_latent, mask_latent, num_steps: int = 50,
                keep: Optional[int] = None, skip_last: int = 0):
    """Invert z0 (B, h, w, 4) -> (x_T, latents (S - skip_last, keep, h, w, 4)).

    ``latents[i]`` is the first ``keep`` rows of the latent after the step at
    ``timesteps[i]``; ``skip_last`` drops the final ascending steps.
    """
    sch = DDIMSchedule.create(model.schedule, num_steps)
    n = sch.num_steps - skip_last
    b = z0.shape[0]
    keep = keep if keep is not None else b
    dev = z0.device
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    x = z0.to(torch.float32)
    latents = []
    for i in range(n):
        t = torch.full((b,), int(sch.timesteps[i]), dtype=torch.int64, device=dev)
        e_t = model.apply_model(torch.cat([x, extra], dim=-1), t, cond)
        x = invert_step(x, e_t, sch, i)
        latents.append(x[:keep])
    return x, torch.stack(latents)


def invert_step(x: torch.Tensor, e_t: torch.Tensor, sch: DDIMSchedule, i: int) -> torch.Tensor:
    """One ascending step with the alpha pair of ``sch``'s step ``i``."""
    an = torch.tensor(sch.inv_alpha_next[i], device=x.device)
    ac = torch.tensor(sch.inv_alpha_cur[i], device=x.device)
    return (x - torch.sqrt(1.0 - ac) * e_t) * torch.sqrt(an / ac) + torch.sqrt(1.0 - an) * e_t
