"""Temporal-consistency metrics of swapped videos (port of ``vface_tpu/eval/temporal.py``).

* :func:`warp_error`: the mean photometric error between frame t and frame
  t-1 warped by the optical flow (lower is smoother);
* :func:`tl_id` / :func:`tg_id`: temporally local / global ID consistency,
  the cosine of ArcFace embeddings between consecutive frames / against the
  sequence's mean embedding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vface_torch.eval._common import as_tensor, eval_net, full_fp32, net_device
from vface_torch.models.arcface import IRSE50, arcface_preprocess
from vface_torch.ops.warp import warp_by_flow


def warp_error(frames01, flow, mask=None) -> float:
    """frames01 (F, H, W, 3); flow (F-1, H, W, 2) mapping frame i+1 back to i;
    mask (F, H, W, 1) restricts the mean to its pixels."""
    frames01 = as_tensor(frames01, "cpu") if not isinstance(frames01, torch.Tensor) else frames01.float()
    flow = as_tensor(flow, frames01.device)
    err = (frames01[1:] - warp_by_flow(frames01[:-1], flow)).abs()
    if mask is not None:
        mask = as_tensor(mask, frames01.device)
        return float((err * mask[1:]).sum() / (mask[1:].sum() * frames01.shape[-1] + 1e-8))
    return float(err.mean())


def _embeddings(params, frames01, model=None, device="cuda") -> torch.Tensor:
    net = eval_net(IRSE50, model if model is not None else params, device)
    with torch.inference_mode(), full_fp32():
        e = net(arcface_preprocess(as_tensor(frames01, net_device(net))))
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)


def tl_id(params, frames01, model=None, device="cuda") -> float:
    """The mean cosine between consecutive frames' embeddings."""
    e = _embeddings(params, frames01, model, device)
    return float((e[1:] * e[:-1]).sum(dim=-1).mean())


def tg_id(params, frames01, model=None, device="cuda") -> float:
    """The mean cosine of each frame's embedding against the normalised mean embedding."""
    e = _embeddings(params, frames01, model, device)
    mean = e.mean(dim=0, keepdim=True)
    mean = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + 1e-8)
    return float((e * mean).sum(dim=-1).mean())


def evaluate_temporal(params_arcface, frames01, flow: Optional[np.ndarray] = None, model=None,
                      device="cuda") -> dict:
    """{"tl_id", "tg_id"[, "warp_error"]} of one clip; the ArcFace net built once."""
    net = eval_net(IRSE50, model if model is not None else params_arcface, device)
    out = {"tl_id": tl_id(None, frames01, net), "tg_id": tg_id(None, frames01, net)}
    if flow is not None:
        out["warp_error"] = warp_error(frames01, flow)
    return out
