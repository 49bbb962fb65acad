"""The VFace hooked sampler: CFG with FSAI/FGATS at the input-block attn1 sites.

Port of ``vface_tpu/samplers/vface.py``: ``vface_sample``, with the
window-packing pair mask (``flow_pair_mask``), the cross-window FGATS carry
(``fgats_prev``, ``fgats_flow0``, ``return_fgats_carry``), ``eta > 0``,
``src_start`` and encoder propagation (``encoder_interval`` with
:func:`encoder_key_steps`), and ``vface_sample_pipelined``, which runs the next
pack's DDIM inversion on the same UNet evals. Per step the UNet sees the batch
[uncond, cond(swap), recon] (``drop_recon_chunk=False``), or [uncond, cond]
with the 3-chunk fusion semantics kept on the 2-chunk batch
(``drop_recon_chunk=True``: the recon chunk only receives fusion and its
output is discarded, so dropping it leaves chunks 0 and 1 unchanged). The
noise of ``eta > 0`` comes from a noise source (:mod:`vface_torch.samplers.ddim`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FlowPack
from vface_torch.samplers.ddim import NoiseFn, ddim_step, draw, noise_source
from vface_torch.samplers.inversion import invert_step
from vface_torch.utils.schedule import DDIMSchedule


def _two_chunk(injection: InjectionSpec, bystander: int = 0) -> InjectionSpec:
    """The 3-chunk fusion semantics on the recon-free [uncond, cond] batch,
    with ``bystander`` trailing rows that neither give nor take fusion."""
    mark = lambda fc: dataclasses.replace(fc, two_chunk_replace=False, bystander=bystander)
    return dataclasses.replace(injection, input_blocks=mark(injection.input_blocks), middle=mark(injection.middle),
                               output_blocks=mark(injection.output_blocks), chunks=2)


def encoder_key_steps(num_steps: int, interval: int, dense_frac: float = 0.2) -> List[bool]:
    """The key steps of encoder propagation ("Faster Diffusion"): the encoder's
    features change fastest early in denoising, so key steps are every step
    up to ``round(dense_frac * num_steps)`` (at least 1) and every
    ``interval``-th after it; all steps for ``interval <= 1``. Indexed by loop
    iteration (0 = the first, noisiest sampling step)."""
    if interval <= 1:
        return [True] * max(num_steps, 1)
    dense = max(1, int(round(dense_frac * num_steps)))
    return [i <= dense or (i - dense) % interval == 0 for i in range(num_steps)]


def eps_with_cache(model, is_key: bool, cache, x_in, t, c_in, **kw):
    """One eval under encoder propagation: the full UNet on a key step, the
    output blocks on ``cache`` elsewhere -> (epsilon, the cache for the next step)."""
    return model.apply_model(x_in, t, c_in, encoder_cache=None if is_key else cache, return_encoder_cache=True,
                             **kw)


def vface_sample(model, x_T, cond, uncond, target_cond, inv_latents, inpaint_latent, mask_latent,
                 injection: InjectionSpec, flow: Optional[torch.Tensor] = None,
                 num_steps: int = 50, cfg_scale: float = 3.0, eta: float = 0.0,
                 src_start: Optional[torch.Tensor] = None, noise: Optional[NoiseFn] = None,
                 encoder_interval: int = 1, drop_recon_chunk: bool = False,
                 fgats_prev: Optional[dict] = None, fgats_flow0: Optional[torch.Tensor] = None,
                 return_fgats_carry: bool = False, flow_pair_mask: Optional[torch.Tensor] = None):
    """Run the hooked sampling loop from x_T (F, h, w, 4); returns (z_0, pred_x0
    trajectory), and the per-step carry stack with ``return_fgats_carry``.

    ``src_start`` (F, h, w, 4) replaces x in the cond chunk at every step.
    ``eta > 0`` adds ``sigma * noise(step_idx, x.shape)`` each step (the
    default source: :func:`~vface_torch.samplers.ddim.seeded_noise`).
    ``encoder_interval > 1`` runs the full UNet on the key steps of
    :func:`encoder_key_steps` (step 0 always is one) and only its output
    blocks, on the last key step's encoder cache, on the others. A cached step
    visits no flow site and gives no carry: with ``return_fgats_carry`` it is
    refused, where the JAX package's ``lax.cond`` refuses the two branches'
    different carries.

    ``inv_latents`` (S, F, h, w, 4) feed the recon chunk (unused when
    ``drop_recon_chunk``); ``flow`` (F-1, Hq, Wq, 2) is the FGATS flow at the
    ds1 token grid, or None. ``flow_pair_mask`` (F-1,), with a flow: 0 turns
    off the FGATS blend of pair (i, i+1), as window packing does at a
    window boundary.

    The cross-window carry: ``fgats_prev`` is the previous window's stack
    {site: {"q": (S, 1, N, D), "k": ...}}, as this function returns it with
    ``return_fgats_carry``; step ``idx`` takes its entry ``idx`` (both windows
    run the same descending schedule). ``fgats_flow0`` (1, Hq, Wq, 2) maps this
    window's frame 0 back to the previous window's last frame. With any of
    these (or a pair mask) the flow reaches the UNet as a :class:`FlowPack`.
    """
    if return_fgats_carry and encoder_interval > 1:
        raise ValueError("return_fgats_carry needs encoder_interval == 1: a cached step gives no FGATS carry")
    sch = DDIMSchedule.create(model.schedule, num_steps, eta=eta)
    n = sch.num_steps
    f = x_T.shape[0]
    dev = x_T.device
    noise = noise_source(noise, eta, dev)
    key_mask = encoder_key_steps(n, encoder_interval)
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    xu9 = None if src_start is None else torch.cat([src_start.to(torch.float32), extra], dim=-1)
    if drop_recon_chunk:
        injection = _two_chunk(injection)
        c_in = torch.cat([uncond, cond], dim=0)
    else:
        c_in = torch.cat([uncond, cond, target_cond], dim=0)
    chunks = 2 if drop_recon_chunk else 3
    use_pack = fgats_prev is not None or return_fgats_carry or flow_pair_mask is not None

    def step_flow(idx):
        if not use_pack:
            return flow
        prev = None if fgats_prev is None else {
            site: {k: v[idx] for k, v in qk.items()} for site, qk in fgats_prev.items()}
        return FlowPack(flow=flow, prev=prev, flow0=fgats_flow0, pair_mask=flow_pair_mask)

    x = x_T.to(torch.float32)
    cache = None
    traj, carries = [], []
    for idx in range(n):
        index = n - 1 - idx
        t = torch.full((f * chunks,), int(sch.timesteps[index]), dtype=torch.int64, device=dev)
        x9 = torch.cat([x, extra], dim=-1)
        parts = [x9, x9 if xu9 is None else xu9]
        if not drop_recon_chunk:
            parts.append(torch.cat([inv_latents[index].to(torch.float32), extra], dim=-1))
        x_in = torch.cat(parts, dim=0)
        if encoder_interval > 1:
            eps, cache = eps_with_cache(model, key_mask[idx], cache, x_in, t, c_in, flow=step_flow(idx),
                                        injection=injection)
        else:
            eps = model.apply_model(x_in, t, c_in, flow=step_flow(idx), injection=injection,
                                    return_fgats_carry=return_fgats_carry)
        if return_fgats_carry:
            eps, carry = eps
            carries.append(carry)
        e_uncond, e_cond = eps[:f], eps[f:2 * f]
        e_t = e_uncond + cfg_scale * (e_cond - e_uncond)
        x, pred_x0 = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index],
                               sch.sqrt_one_minus_alphas[index], sch.sigmas[index], draw(noise, idx, x))
        traj.append(pred_x0)
    if return_fgats_carry:
        stack = {site: {k: torch.stack([c[site][k] for c in carries]) for k in qk}
                 for site, qk in carries[0].items()}
        return x, torch.stack(traj), stack
    return x, torch.stack(traj)


def vface_sample_pipelined(model, x_T, cond, uncond, inpaint_latent, mask_latent, injection: InjectionSpec, *,
                           next_z0, next_cond, next_inpaint, next_mask, inversion_steps: int = 50,
                           skip_last: int = 1, flow: Optional[torch.Tensor] = None, num_steps: int = 50,
                           cfg_scale: float = 3.0, eta: float = 0.0, noise: Optional[NoiseFn] = None,
                           flow_pair_mask: Optional[torch.Tensor] = None):
    """Recon-free sampling of pack i fused with the DDIM inversion of pack i+1.

    Each step runs one UNet eval of b = 2F + G: pack i's [uncond, cond] rows
    (F each) and pack i+1's G inversion rows, marked ``bystander`` so that they
    neither give nor take FSAI/FGATS (hooks are off during inversion). The
    result is ``vface_sample(drop_recon_chunk=True)`` for pack i and
    ``ddim_invert(..., skip_last=skip_last)`` for pack i+1: sampling descends
    the timesteps; the inversion ascends with its own alpha pairs and stops
    after its ``n_inv = S_inv - skip_last`` steps (its rows ride the later
    evals at its last timestep, their output unused), so ``n_inv`` <= the
    sampling steps. ``eta > 0`` adds the sampling rows' noise as
    :func:`vface_sample` does. Returns (z0, pred_x0 trajectory, next_x_T),
    ``next_x_T`` the inversion's start code. ``injection.conv_inject`` is
    refused (ValueError), as in the JAX package.
    """
    if injection.conv_inject:
        # the conv injection splits the batch by chunks alone and knows no bystander rows
        raise ValueError("pipelined packs do not support conv_inject")
    sch = DDIMSchedule.create(model.schedule, num_steps, eta=eta)
    n = sch.num_steps
    sch_i = DDIMSchedule.create(model.schedule, inversion_steps)
    n_inv = sch_i.num_steps - skip_last
    if n_inv > n:
        raise ValueError(f"pipelined pack needs inversion steps ({n_inv}) <= sampling steps ({n}); "
                         "use the sequential path instead")
    f, g = x_T.shape[0], next_z0.shape[0]
    dev = x_T.device
    noise = noise_source(noise, eta, dev)
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    extra_i = torch.cat([next_inpaint, next_mask], dim=-1).to(torch.float32)
    injection = _two_chunk(injection, bystander=g)
    c_in = torch.cat([uncond, cond, next_cond], dim=0)
    fl = flow if flow_pair_mask is None else FlowPack(flow=flow, pair_mask=flow_pair_mask)

    x, xi = x_T.to(torch.float32), next_z0.to(torch.float32)
    traj = []
    for idx in range(n):
        index = n - 1 - idx
        ii = min(idx, n_inv - 1)
        t = torch.cat([torch.full((2 * f,), int(sch.timesteps[index]), dtype=torch.int64, device=dev),
                       torch.full((g,), int(sch_i.timesteps[ii]), dtype=torch.int64, device=dev)])
        x9 = torch.cat([x, extra], dim=-1)
        eps = model.apply_model(torch.cat([x9, x9, torch.cat([xi, extra_i], dim=-1)], dim=0), t, c_in, flow=fl,
                                injection=injection)
        e_uncond, e_cond, e_inv = eps[:f], eps[f:2 * f], eps[2 * f:]
        e_t = e_uncond + cfg_scale * (e_cond - e_uncond)
        x, pred_x0 = ddim_step(x, e_t, sch.alphas[index], sch.alphas_prev[index],
                               sch.sqrt_one_minus_alphas[index], sch.sigmas[index], draw(noise, idx, x))
        traj.append(pred_x0)
        if idx < n_inv:
            xi = invert_step(xi, e_inv, sch_i, ii)
    return x, torch.stack(traj), xi
