"""Frame-parallel hooked sampling: one window's frames sharded over the ranks.

Port of ``vface_tpu/parallel/frame_sharded.py``. The production multi-GPU
path is window-parallel (independent windows dealt to the ranks,
``VideoSwapPipeline.swap_video_frames_sharded``); this is the other axis, for
the latency-bound case of few frames on many cards. Everything inside a
sampling step is frame-local except the FGATS blend, whose 1-frame dependency
is one point-to-point halo per flow site and step
(:func:`vface_torch.ops.warp.align_by_flow_halo`), selected by
``FusionConfig.flow_axis``: no all-gather of the window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vface_torch.parallel.mesh import Mesh, bind_axis, shard_rows


def _with_flow_axis(injection, axis_name: str):
    """Every fusion site flagged with the shard axis (a name: the config stays hashable)."""
    return dataclasses.replace(
        injection,
        input_blocks=dataclasses.replace(injection.input_blocks, flow_axis=axis_name),
        middle=dataclasses.replace(injection.middle, flow_axis=axis_name),
        output_blocks=dataclasses.replace(injection.output_blocks, flow_axis=axis_name),
    )


def padded_flow_layout(flow: torch.Tensor, flow_pair_mask: Optional[torch.Tensor] = None):
    """The (F-1,) pairwise flow and pair mask -> the (F,) left-padded per-frame
    layout: slot i = pair (i-1, i); global frame 0's slot is dead (mask 0)."""
    f = flow.shape[0] + 1
    flow_pad = torch.cat([torch.zeros_like(flow[:1]), flow], dim=0)
    pm = (torch.ones((f - 1,), dtype=torch.float32, device=flow.device) if flow_pair_mask is None
          else flow_pair_mask.to(device=flow.device, dtype=torch.float32))
    return flow_pad, torch.cat([torch.zeros((1,), dtype=torch.float32, device=flow.device), pm])


def vface_sample_frame_sharded(model, x_T, cond, uncond, target_cond, inpaint_latent, mask_latent, injection,
                               flow: Optional[torch.Tensor], mesh: Mesh, num_steps: int = 50,
                               cfg_scale: float = 3.0, eta: float = 0.0, encoder_interval: int = 1,
                               axis_name: str = "data", flow_pair_mask: Optional[torch.Tensor] = None,
                               noise=None) -> torch.Tensor:
    """Hooked 2-chunk CFG sampling of one window with its F frames sharded over
    the ranks of ``mesh``, FGATS on across the shard boundaries.

    Each rank passes its own F / n frames of x_T, the conditionings and the
    latents (the rows ``shard_rows(mesh, F)`` of the window: x_T (F / n, h,
    w, 4), ...) and the whole window's ``flow`` (F-1, Hq, Wq, 2) at the token
    grid and ``flow_pair_mask`` (F-1,), and gets its F / n frames of z_0
    back. The arguments are :func:`vface_torch.samplers.vface.vface_sample`'s
    with the recon-free semantics (``drop_recon_chunk=True``). F is the
    flow's ``F-1`` pairs plus one; the JAX package's ``ValueError``s refuse
    an F the ranks do not divide and a missing flow (checked first here: F
    comes from the flow)."""
    from vface_torch.samplers.vface import vface_sample

    n = mesh.size
    if flow is None:
        raise ValueError("frame-sharded sampling is the flow-on path; pass flow")
    f = flow.shape[0] + 1
    if f % n:
        raise ValueError(f"frames ({f}) must divide over the {axis_name} axis ({n})")
    inj = _with_flow_axis(injection, axis_name)
    flow_pad, pm_pad = padded_flow_layout(flow, flow_pair_mask)
    rows = shard_rows(mesh, f)
    with bind_axis(axis_name, mesh):
        z0, _ = vface_sample(model, x_T, cond, uncond, target_cond, None, inpaint_latent, mask_latent, inj,
                             flow=flow_pad[rows], num_steps=num_steps, cfg_scale=cfg_scale, eta=eta, noise=noise,
                             encoder_interval=encoder_interval, drop_recon_chunk=True, flow_pair_mask=pm_pad[rows])
    return z0
