"""DDIM inversion with the latent stack kept on the device.

Port of ``vface_tpu/samplers/inversion.py::ddim_invert``: an ascending pass
over the DDIM timesteps with the custom alpha indexing

    alpha_next = alphas_cumprod[step]
    alpha_cur  = alphas_cumprod[max(0, step - T // S)]
    x <- (x - sqrt(1 - alpha_cur) e_t) sqrt(alpha_next / alpha_cur) + sqrt(1 - alpha_next) e_t

with optional CFG (the [uncond, cond] batch) and encoder propagation. The JAX
``lax.scan`` is a Python loop here. Hooks are off during inversion, so the
UNet runs without injection.
"""

from __future__ import annotations

from typing import Optional

import torch

from vface_torch.utils.schedule import DDIMSchedule


def ddim_invert(model, z0, cond, inpaint_latent, mask_latent, num_steps: int = 50,
                uncond: Optional[torch.Tensor] = None, cfg_scale: float = 1.0, keep: Optional[int] = None,
                encoder_interval: int = 1, skip_last: int = 0):
    """Invert z0 (B, h, w, 4) -> (x_T, latents (S - skip_last, keep, h, w, 4)).

    ``latents[i]`` is the first ``keep`` rows of the latent after the step at
    ``timesteps[i]``; ``skip_last`` drops the final ascending steps. CFG is on
    when ``uncond`` is given and ``cfg_scale != 1``: each step runs [uncond,
    cond] and takes ``e_uncond + cfg_scale (e_cond - e_uncond)``.

    ``encoder_interval > 1`` runs the full UNet only on key steps and the
    output blocks on the last key step's encoder cache elsewhere, with the key
    mask of :func:`~vface_torch.samplers.vface.encoder_key_steps` read mirrored
    (step i is a key step where ``mask[S' - 1 - i]``, S' the steps run): the
    inversion ascends t, so its high-noise steps come last. As in the JAX
    package, a first step that is not a key step runs on a cache of zeros.
    """
    from vface_torch.samplers.vface import encoder_key_steps, eps_with_cache

    sch = DDIMSchedule.create(model.schedule, num_steps)
    n = sch.num_steps - skip_last
    b = z0.shape[0]
    keep = keep if keep is not None else b
    dev = z0.device
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    use_cfg = uncond is not None and cfg_scale != 1.0
    c_in = torch.cat([uncond, cond], dim=0) if use_cfg else cond
    key_mask = encoder_key_steps(n, encoder_interval)
    x = z0.to(torch.float32)
    cache = None
    latents = []
    for i in range(n):
        x9 = torch.cat([x, extra], dim=-1)
        x_in = torch.cat([x9, x9], dim=0) if use_cfg else x9
        t = torch.full((x_in.shape[0],), int(sch.timesteps[i]), dtype=torch.int64, device=dev)
        if encoder_interval > 1:
            if not key_mask[n - 1 - i] and cache is None:
                cache = model.unet.zero_encoder_cache(x_in.shape[0], x_in.shape[1], x_in.shape[2], dev)
            eps, cache = eps_with_cache(model, key_mask[n - 1 - i], cache, x_in, t, c_in)
        else:
            eps = model.apply_model(x_in, t, c_in)
        e_t = eps[:b] + cfg_scale * (eps[b:] - eps[:b]) if use_cfg else eps
        x = invert_step(x, e_t, sch, i)
        latents.append(x[:keep])
    return x, torch.stack(latents)


def invert_step(x: torch.Tensor, e_t: torch.Tensor, sch: DDIMSchedule, i: int) -> torch.Tensor:
    """One ascending step with the alpha pair of ``sch``'s step ``i``."""
    an = torch.tensor(sch.inv_alpha_next[i], device=x.device)
    ac = torch.tensor(sch.inv_alpha_cur[i], device=x.device)
    return (x - torch.sqrt(1.0 - ac) * e_t) * torch.sqrt(an / ac) + torch.sqrt(1.0 - an) * e_t
