"""Guided DDIM sampling: ID-similarity scaling and gradient guidance.

Port of ``vface_tpu/samplers/guided.py``. Each step runs the 2-chunk CFG
eval, then:

* ``grad_weight > 0``: decode pred_x0, mask it to the face region, embed it
  with the conditioner's ArcFace, and move pred_x0 by ``-grad_weight`` times
  the gradient of the mean ``1 - cos(embedding, src_emb)`` with respect to
  pred_x0 (the decode and ArcFace differentiated; the model's parameters
  stay out of the graph);
* ``id_dir_scaling``: scale the ``dir_xt`` term by ``clamp(3 cos, 0, 1)`` of
  the (nudged) pred_x0's decode, so samples that already resemble the
  source keep their trajectory.

The UNet eval runs without a gradient, so its wide feed-forward sites keep
their kernel.
"""

from __future__ import annotations

import contextlib

import torch

from vface_torch.models.arcface import arcface_preprocess, safe_l2_normalize
from vface_torch.utils.schedule import DDIMSchedule


def id_similarity(model, pred_x0, src_emb, keep_mask_img) -> torch.Tensor:
    """Decode pred_x0, mask it to the face region (``1 - keep_mask_img``), embed
    it with the conditioner's ArcFace and return the cosine with ``src_emb``, (B,)."""
    img01 = torch.clamp((model.decode_first_stage(pred_x0) + 1.0) * 0.5, 0.0, 1.0)
    emb = safe_l2_normalize(model._conditioner().arcface(arcface_preprocess(img01 * (1.0 - keep_mask_img))))
    return (emb * src_emb).sum(dim=-1)


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """The module's parameters out of any graph built inside: requires_grad off, restored after."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def id_loss_grad(model, pred_x0, src_emb, keep_mask_img) -> torch.Tensor:
    """The gradient of ``mean(1 - id_similarity)`` with respect to pred_x0."""
    with frozen(model), torch.enable_grad():
        x0 = pred_x0.detach().requires_grad_(True)
        loss = (1.0 - id_similarity(model, x0, src_emb, keep_mask_img)).mean()
        (grad,) = torch.autograd.grad(loss, x0)
    return grad


def ddim_sample_guided(model, x_T, cond, uncond, inpaint_latent, mask_latent, src_emb, keep_mask_img,
                       num_steps: int = 50, cfg_scale: float = 3.0, id_dir_scaling: bool = True,
                       grad_weight: float = 0.0):
    """Guided CFG DDIM from x_T (B, h, w, 4) -> (z_0, pred_x0 trajectory).

    ``src_emb`` (B, 512) is the normalised source ArcFace embedding and
    ``keep_mask_img`` (B, H, W, 1) the image-resolution keep-mask (1 =
    background). The model needs its conditioner (its ArcFace). Not under
    ``torch.inference_mode``: the gradient guidance records a graph.
    """
    sch = DDIMSchedule.create(model.schedule, num_steps)
    n = sch.num_steps
    b = x_T.shape[0]
    dev = x_T.device
    extra = torch.cat([inpaint_latent, mask_latent], dim=-1).to(torch.float32)
    c_in = torch.cat([uncond, cond], dim=0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    x = x_T.to(torch.float32)
    traj = []
    for idx in range(n):
        index = n - 1 - idx
        a_t, a_prev = f32(sch.alphas[index]), f32(sch.alphas_prev[index])
        with torch.no_grad():
            x9 = torch.cat([x, extra], dim=-1)
            t = torch.full((2 * b,), int(sch.timesteps[index]), dtype=torch.int64, device=dev)
            eps = model.apply_model(torch.cat([x9, x9], dim=0), t, c_in)
        e_t = eps[:b] + cfg_scale * (eps[b:] - eps[:b])
        pred_x0 = (x - f32(sch.sqrt_one_minus_alphas[index]) * e_t) / torch.sqrt(a_t)
        if grad_weight > 0.0:
            pred_x0 = pred_x0 - grad_weight * id_loss_grad(model, pred_x0, src_emb, keep_mask_img)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e_t
        if id_dir_scaling:
            with torch.no_grad():
                sim = id_similarity(model, pred_x0, src_emb, keep_mask_img)
            dir_xt = dir_xt * torch.clamp(3.0 * sim, 0.0, 1.0)[:, None, None, None]
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        traj.append(pred_x0)
    return x, torch.stack(traj)
