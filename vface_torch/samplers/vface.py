"""The VFace hooked sampler: CFG with FSAI/FGATS at the input-block attn1 sites.

Port of ``vface_tpu/samplers/vface.py::vface_sample`` for ``eta = 0``,
``encoder_interval = 1`` and a bare flow array. Per step the UNet sees the
batch [uncond, cond(swap), recon] (``drop_recon_chunk=False``), or
[uncond, cond] with the 3-chunk fusion semantics kept on the 2-chunk batch
(``drop_recon_chunk=True``: the recon chunk only receives fusion and its
output is discarded, so dropping it leaves chunks 0 and 1 unchanged).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vface_torch.models.unet import InjectionSpec
from vface_torch.samplers.ddim import ddim_step
from vface_torch.utils.schedule import DDIMSchedule


def vface_sample(model, x_T, cond, uncond, target_cond, inv_latents, inpaint_latent, mask_latent,
                 injection: InjectionSpec, flow: Optional[torch.Tensor] = None,
                 num_steps: int = 50, cfg_scale: float = 3.0, drop_recon_chunk: bool = False):
    """Run the hooked sampling loop from x_T (F, h, w, 4); returns (z_0, pred_x0 trajectory).

    ``inv_latents`` (S, F, h, w, 4) feed the recon chunk (unused when
    ``drop_recon_chunk``); ``flow`` (F-1, Hq, Wq, 2) is the FGATS flow at the
    ds1 token grid, or None.
    """
    sch = DDIMSchedule.create(model.schedule, num_steps)
    n = sch.num_steps
    f = x_T.shape[0]
    dev = x_T.device
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    if drop_recon_chunk:
        keep3 = lambda fc: dataclasses.replace(fc, two_chunk_replace=False)
        injection = dataclasses.replace(
            injection, input_blocks=keep3(injection.input_blocks), middle=keep3(injection.middle),
            output_blocks=keep3(injection.output_blocks), chunks=2)
        c_in = torch.cat([uncond, cond], dim=0)
    else:
        c_in = torch.cat([uncond, cond, target_cond], dim=0)
    chunks = 2 if drop_recon_chunk else 3

    x = x_T.to(torch.float32)
    traj = []
    for idx in range(n):
        index = n - 1 - idx
        t = torch.full((f * chunks,), int(sch.timesteps[index]), dtype=torch.int64, device=dev)
        x9 = torch.cat([x, extra], dim=-1)
        parts = [x9, x9]
        if not drop_recon_chunk:
            parts.append(torch.cat([inv_latents[index].to(torch.float32), extra], dim=-1))
        eps = model.apply_model(torch.cat(parts, dim=0), t, c_in, flow=flow, injection=injection)
        e_uncond, e_cond = eps[:f], eps[f:2 * f]
        e_t = e_uncond + cfg_scale * (e_cond - e_uncond)
        x, pred_x0 = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index],
                               sch.sqrt_one_minus_alphas[index], sch.sigmas[index])
        traj.append(pred_x0)
    return x, torch.stack(traj)
