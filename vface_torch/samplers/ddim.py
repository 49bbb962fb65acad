"""DDIM: the update, the CFG sampler and the train-time reconstruction chain.

Port of ``vface_tpu/samplers/ddim.py``'s ``ddim_step``, ``ddim_sample``,
``train_recon_timesteps`` and ``ddim_sample_train``:

    pred_x0 = (x - sqrt(1 - a_t) * e_t) / sqrt(a_t)
    dir_xt  = sqrt(1 - a_prev - sigma^2) * e_t
    x_prev  = sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise

The noise of ``eta > 0`` comes from a noise source, ``noise(step_idx, shape)
-> Tensor``, called once per step in step order. The JAX samplers draw it from
``PRNGKey(0)`` afresh on each call; torch cannot replay that stream, so the
default source (:func:`seeded_noise`) is a ``torch.Generator`` seeded with 0
afresh on each call, and a caller that needs JAX's draws passes a source that
gives them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vface_torch.utils.schedule import DDIMSchedule

NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


def seeded_noise(device, seed: int = 0) -> NoiseFn:
    """Standard normal draws from a ``torch.Generator`` on ``device`` seeded
    with ``seed``: the default noise source, made afresh for each sampler call."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda step_idx, shape: torch.randn(shape, generator=gen, device=device)


def noise_source(noise: Optional[NoiseFn], eta: float, device) -> Optional[NoiseFn]:
    """The noise source of one sampler call: None at eta = 0 (no draws),
    ``noise`` where given, else :func:`seeded_noise` on ``device``."""
    if eta == 0.0:
        return None
    return noise if noise is not None else seeded_noise(device)


def draw(noise: Optional[NoiseFn], step_idx: int, x: torch.Tensor) -> Optional[torch.Tensor]:
    """Step ``step_idx``'s noise of x's shape, float32 on x's device (None without a source)."""
    if noise is None:
        return None
    return noise(step_idx, tuple(x.shape)).to(device=x.device, dtype=torch.float32)


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


def ddim_sample(model, x_T, cond, uncond, inpaint_latent, mask_latent, num_steps: int = 50,
                cfg_scale: float = 3.0, eta: float = 0.0, noise: Optional[NoiseFn] = None):
    """CFG DDIM sampling from x_T (B, h, w, 4) -> (z_0, pred_x0 trajectory (S, B, h, w, 4)).

    Each step runs the 2-chunk [uncond, cond] batch with the fixed inpainting
    channels (``inpaint_latent`` (B, h, w, 4), ``mask_latent`` (B, h, w, 1))
    and ``e_t = e_uncond + cfg_scale (e_cond - e_uncond)``; with ``eta > 0``
    each step adds ``sigma * noise(step_idx, x.shape)``.
    """
    sch = DDIMSchedule.create(model.schedule, num_steps, eta=eta)
    n = sch.num_steps
    b = x_T.shape[0]
    noise = noise_source(noise, eta, x_T.device)
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    c_in = torch.cat([uncond, cond], dim=0)
    x = x_T.to(torch.float32)
    traj = []
    for idx in range(n):
        index = n - 1 - idx
        t = torch.full((2 * b,), int(sch.timesteps[index]), dtype=torch.int64, device=x.device)
        x9 = torch.cat([x, extra], dim=-1)
        eps = model.apply_model(torch.cat([x9, x9], dim=0), t, c_in)
        e_t = eps[:b] + cfg_scale * (eps[b:] - eps[:b])
        x, pred_x0 = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index], sch.sqrt_one_minus_alphas[index],
                               sch.sigmas[index], draw(noise, idx, x))
        traj.append(pred_x0)
    return x, torch.stack(traj)


def train_recon_timesteps(t_start: int, num_steps: int) -> np.ndarray:
    """The reference's train-time reconstruction timesteps: ``skip = (t-1) // S``
    (at least 1), ``range(1, t-1, skip)`` cut to S entries, descending. For
    t = 999, S = 4: [748, 499, 250, 1], not a uniform grid from t."""
    skip = max((t_start - 1) // num_steps, 1)
    seq = list(range(1, t_start - 1, skip))[:num_steps]
    return np.asarray(seq[::-1], dtype=np.int32)


def ddim_sample_train(model, x_start_noisy: torch.Tensor, t_start: int, num_steps: int,
                      cond: torch.Tensor, inpaint_latent: torch.Tensor, mask_latent: torch.Tensor,
                      log_every_t: int = 100):
    """The differentiable short reconstruction of the training loss; returns
    ``(z_final, intermediates)`` with the intermediates stacked (K, B, h, w, 4).

    The reference's runtime quirks, each kept:

    * the UNet sees the per-step t of :func:`train_recon_timesteps`, but the
      update's coefficients come from the uniform ``make_schedule(S)`` table
      indexed by loop position (``index = S-1-i``);
    * no CFG (a single-chunk model call) and eta = 0;
    * the intermediates start with the noisy start latent itself, then
      pred_x0 where ``index % log_every_t == 0 or index == S-1`` (for S = 4:
      [x_T, pred_x0 at i = 0, pred_x0 at i = 3]).
    """
    seq = train_recon_timesteps(t_start, num_steps)
    total = len(seq)
    acp = np.asarray(model.schedule.alphas_cumprod)
    n_t = model.schedule.num_timesteps
    ddim_ts = np.arange(0, n_t, n_t // num_steps) + 1
    a_tab = acp[ddim_ts]
    a_prev_tab = np.concatenate([[acp[0]], acp[ddim_ts[:-1]]])
    b = x_start_noisy.shape[0]
    dev = x_start_noisy.device
    f32 = lambda val: torch.tensor(val, dtype=torch.float32, device=dev)
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1)
    x = x_start_noisy.to(torch.float32)
    inters = [x]
    for i in range(total):
        index = total - 1 - i
        t = torch.full((b,), int(seq[i]), dtype=torch.long, device=dev)
        a_t, a_prev = f32(a_tab[index]), f32(a_prev_tab[index])
        e_t = model.apply_model(torch.cat([x, extra], dim=-1), t, cond)
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e_t
        if index % log_every_t == 0 or index == total - 1:
            inters.append(pred_x0)
    return x, torch.stack(inters)
