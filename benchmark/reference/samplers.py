"""The benchmark reference's samplers, at the cells' operating point (eta 0, every
step a full UNet eval): DDIM inversion without guidance, the VFace sampler
(recon-free [uncond, cond] batch, FSAI and FGATS at the input blocks) and CFG
DDIM. Frozen float32 forms of ``vface_torch/samplers/{inversion,vface,ddim}.py``
on that path; they import nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.schedule import DDIMSchedule
from benchmark.reference.unet import InjectionSpec


def ddim_step(x, e_t, a_t: float, a_prev: float, sqrt_1m_at: float):
    """One deterministic DDIM update; the schedule's float32 scalars."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    a_t, a_prev, sqrt_1m_at = f32(a_t), f32(a_prev), f32(sqrt_1m_at)
    pred_x0 = (x - sqrt_1m_at * e_t) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e_t


def ddim_invert(model, z0, cond, inpaint_latent, mask_latent, num_steps: int, skip_last: int = 0):
    """The ascending pass from z0 (B, h, w, 4): the latent after each step, (S - skip_last, B, h, w, 4)."""
    sch = DDIMSchedule.create(model.schedule, num_steps)
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    x = z0.to(torch.float32)
    latents = []
    for i in range(sch.num_steps - skip_last):
        t = torch.full((x.shape[0],), int(sch.timesteps[i]), dtype=torch.int64, device=x.device)
        e_t = model.apply_model(torch.cat([x, extra], dim=-1), t, cond)
        an = torch.tensor(sch.inv_alpha_next[i], device=x.device)
        ac = torch.tensor(sch.inv_alpha_cur[i], device=x.device)
        x = (x - torch.sqrt(1.0 - ac) * e_t) * torch.sqrt(an / ac) + torch.sqrt(1.0 - an) * e_t
        latents.append(x)
    return torch.stack(latents)


def vface_sample(model, x_T, cond, uncond, inpaint_latent, mask_latent, injection: InjectionSpec, flow,
                 num_steps: int, cfg_scale: float):
    """The hooked CFG loop from x_T (F, h, w, 4) -> z_0 on the recon-free
    [uncond, cond] batch (``injection.chunks`` 2: chunk 1 takes the fusion);
    ``flow`` (F-1, Hq, Wq, 2) at the ds1 token grid, or None."""
    sch = DDIMSchedule.create(model.schedule, num_steps)
    f = x_T.shape[0]
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    c_in = torch.cat([uncond, cond], dim=0)
    x = x_T.to(torch.float32)
    for index in reversed(range(sch.num_steps)):
        t = torch.full((2 * f,), int(sch.timesteps[index]), dtype=torch.int64, device=x.device)
        x9 = torch.cat([x, extra], dim=-1)
        eps = model.apply_model(torch.cat([x9, x9], dim=0), t, c_in, flow=flow, injection=injection)
        e_t = eps[:f] + cfg_scale * (eps[f:] - eps[:f])
        x = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index], sch.sqrt_one_minus_alphas[index])
    return x


def ddim_sample(model, x_T, cond, uncond, inpaint_latent, mask_latent, num_steps: int, cfg_scale: float):
    """CFG DDIM from x_T (B, h, w, 4) on the [uncond, cond] batch -> z_0."""
    sch = DDIMSchedule.create(model.schedule, num_steps)
    b = x_T.shape[0]
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    c_in = torch.cat([uncond, cond], dim=0)
    x = x_T.to(torch.float32)
    for index in reversed(range(sch.num_steps)):
        t = torch.full((2 * b,), int(sch.timesteps[index]), dtype=torch.int64, device=x.device)
        x9 = torch.cat([x, extra], dim=-1)
        eps = model.apply_model(torch.cat([x9, x9], dim=0), t, c_in)
        e_t = eps[:b] + cfg_scale * (eps[b:] - eps[:b])
        x = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index], sch.sqrt_one_minus_alphas[index])
    return x
