"""Training: the REFace self-supervised inpainting objective, PyTorch.

Port of ``vface_tpu/pipelines/train.py`` (``TrainConfig``, ``trainable_mask``,
``make_optimizer``, ``vlb_weights``, ``p_losses_face``, ``make_train_step``,
``make_split_train_step``):

* the epsilon-MSE "simple" loss at a random t, with the VLB term
  (``original_elbo_weight``) and the landmark MSE from the UNet's last two
  output-block activations through the bundle's ``landmark_head`` (skipped
  when the model has none, as JAX skips it without ``params["landmark_head"]``);
* the train-time DDIM reconstruction: the same noise draw re-noised to
  t = T-1, the reference batch flipped so each sample reconstructs with
  another source's conditioning, the differentiable S-step DDIM chain
  (:func:`vface_torch.samplers.ddim.ddim_sample_train`), every logged
  intermediate decoded, the masked ArcFace ID loss against the flipped
  reference identity and LPIPS (``perceptual_fn``) per intermediate at three
  adaptive-avg-pooled scales;
* condition dropout to the learnable uncond vector;
* AdamW with the reference's linear warm-up (``LambdaLR``), over the whole
  UNet or only its attn2/norm2 parameters (``partial_unet``).

Randomness comes from an explicit ``torch.Generator`` on the model's device;
``fixed`` overrides the draws (tests share them with the JAX package). Memory
for back-propagating through the sampler comes from the UNet's ``use_remat``.
``loss_parts`` "eps" / "recon" compute one part's terms while making every
draw of the fused loss, so that from one generator state the two parts'
gradients add up to the fused gradient (:func:`make_split_train_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vface_torch.models.arcface import arcface_preprocess, safe_l2_normalize
from vface_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, clip_preprocess
from vface_torch.ops.pooling import adaptive_avg_pool
from vface_torch.ops.warp import resize_bilinear
from vface_torch.samplers.ddim import ddim_sample_train
from vface_torch.utils.lr_schedules import lambda_linear_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1.0e-5
    warmup_steps: int = 10_000
    u_cond_percent: float = 0.2
    reconstruct_steps: int = 4
    id_loss_weight: float = 0.3
    lpips_loss_weight: float = 0.1
    landmark_loss_weight: float = 0.0
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    reconstruct: bool = True
    weight_decay: float = 1e-2
    # "all": the fused loss; "eps" / "recon": only that part's terms, with the
    # same draws (make_split_train_step)
    loss_parts: str = "all"


def trainable_mask(model, partial_unet: bool = False) -> dict:
    """Set ``requires_grad`` on exactly the reference's trainable set and return
    ``{parameter name: trainable}``: the whole UNet (with ``partial_unet`` only
    its attn2 and norm2 parameters), CLIP's mapper2 and final_ln2, the
    conditioning heads, the learnable uncond vector and the landmark head. The
    VAE, ArcFace, the CLIP vision tower and visual_projection stay frozen."""

    def decide(name: str) -> bool:
        top, *rest = name.split(".")
        if top == "vae":
            return False
        if top == "unet":
            return not partial_unet or any(k in ("attn2", "norm2") for k in rest)
        if top != "conditioner":
            return True  # the landmark head
        if rest[0] == "arcface":
            return False
        if rest[0] == "clip_encoder":
            return rest[1].startswith("mapper2") or rest[1] == "final_ln2"
        return True  # proj_out_*, id_proj_out, landmark_proj_out, learnable_vector

    mask = {}
    for name, p in model.named_parameters():
        mask[name] = decide(name)
        p.requires_grad_(mask[name])
    return mask


def make_optimizer(cfg: TrainConfig, model, partial_unet: bool = False):
    """AdamW (betas 0.9/0.999, eps 1e-8, ``cfg.weight_decay``) over the
    trainable set (:func:`trainable_mask`), with ``LambdaLR`` over the
    reference's warm-up multiplier. Returns ``(optimizer, scheduler)``; step
    the scheduler after each optimizer step, so that the first step runs at
    multiplier f(0) as optax's count 0 does."""
    trainable_mask(model, partial_unet)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda_linear_schedule(warm_up_steps=cfg.warmup_steps))
    return opt, sched


def vlb_weights(model) -> torch.Tensor:
    """Per-timestep VLB weight for the epsilon parameterisation, float32 (T,):
    the weight of the reference's ``original_elbo_weight`` term (off at the
    reference operating point)."""
    s = model.schedule
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    betas, acp, acp_prev = f32(s.betas), f32(s.alphas_cumprod), f32(s.alphas_cumprod_prev)
    w = betas**2 / (2 * (1 - acp) * (1.0 - betas) * (1 - acp_prev) + 1e-20)
    w[0] = w[1]
    return w


def p_losses_face(model, batch: dict, generator: Optional[torch.Generator] = None,
                  cfg: TrainConfig = TrainConfig(), fixed: Optional[dict] = None,
                  perceptual_fn: Optional[Callable] = None):
    """The REFace face loss; returns ``(loss, logs)``. ``batch`` holds tensors on
    the model's device:

    gt_image (B, H, W, 3) in [-1, 1]; inpaint (B, H, W, 3) the masked GT;
    mask (B, H, W, 1), 1 = keep; ref_clip (B, S, S, 3) the CLIP-normalised
    reference face; ref_face01 (B, h, w, 3) the [0, 1] reference for ArcFace
    (optional); landmarks (B, 136) (optional).

    ``fixed`` overrides draws: ``t`` (B,), ``noise`` (B, h, w, 4), ``drop``
    (B, 1, 1) bool, ``enc_eps0``/``enc_eps1`` (B, h, w, 4) the posterior draws.
    The others come from ``generator`` in the order enc_eps0, enc_eps1, drop,
    t, noise, whatever ``cfg.loss_parts`` is. ``perceptual_fn(a, b) -> (B,)``
    (LPIPS, :func:`vface_torch.eval.lpips.make_lpips_fn`) adds the perceptual
    term at ``cfg.lpips_loss_weight``.
    """
    fixed = fixed or {}
    gt = batch["gt_image"]
    b, hh, ww = gt.shape[:3]
    dev = gt.device
    eps_part = cfg.loss_parts in ("all", "eps")
    recon_part = cfg.reconstruct and cfg.loss_parts in ("all", "recon")

    # latents: sampled posteriors, as the reference trains
    if "enc_eps0" in fixed:
        z0 = model.encode_first_stage_given_eps(gt, fixed["enc_eps0"])
        z_inpaint = model.encode_first_stage_given_eps(batch["inpaint"], fixed["enc_eps1"])
    else:
        z0 = model.encode_first_stage_sample(gt, generator)
        z_inpaint = model.encode_first_stage_sample(batch["inpaint"], generator)
    hl = z0.shape[1]
    mask_lat = resize_bilinear(batch["mask"], hl, hl, antialias=False)

    # the draws of the epsilon loss, made for either part
    drop = fixed.get("drop")
    if drop is None:
        drop = torch.rand((b, 1, 1), generator=generator, device=dev) < cfg.u_cond_percent
    t = fixed.get("t")
    if t is None:
        t = torch.randint(0, model.schedule.num_timesteps, (b,), generator=generator, device=dev)
    noise = fixed.get("noise")
    if noise is None:
        noise = torch.randn(z0.shape, generator=generator, device=dev)

    # the GT image feeds the conditioner's target branch
    tar_clip = clip_preprocess((gt + 1.0) * 0.5, size=model.cfg.cond.clip.image_size)
    loss = torch.zeros((), device=dev)
    logs = {}
    if eps_part:
        # epsilon loss at a random t, with uncond dropout
        cond = model.conditioning(batch["ref_clip"], batch.get("landmarks"), tar_clip, batch.get("ref_face01"))
        cond = torch.where(drop, model.uncond(b), cond)
        x9 = model.build_unet_input(model.q_sample(z0, t, noise), z_inpaint, mask_lat)
        need_feats = cfg.landmark_loss_weight > 0 and "landmarks" in batch
        if need_feats:
            eps, feats = model.apply_model(x9, t, cond, return_features=True)
        else:
            eps = model.apply_model(x9, t, cond)
        simple = ((eps - noise) ** 2).mean(dim=(1, 2, 3))
        loss = loss + cfg.l_simple_weight * simple.mean()
        logs["loss_simple"] = simple.mean()
        if cfg.original_elbo_weight > 0:
            vlb = (vlb_weights(model).to(dev)[t] * simple).mean()
            loss = loss + cfg.original_elbo_weight * vlb
            logs["loss_vlb"] = vlb
        if need_feats and model.landmark_head is not None:
            # the head reads the two final full-latent-scale output-block activations
            pred_lm = model.landmark_head(torch.cat([feats[-2], feats[-1]], dim=-1))
            lm_loss = ((pred_lm - batch["landmarks"]) ** 2).mean()
            loss = loss + cfg.landmark_loss_weight * lm_loss
            logs["loss_landmark"] = lm_loss

    # train-time DDIM reconstruction with the ID and perceptual losses
    if recon_part:
        t_max = model.schedule.num_timesteps - 1
        # the eps loss's noise draw again, re-noised to T-1
        z_hi = model.q_sample(z0, torch.full((b,), t_max, dtype=torch.long, device=dev), noise)
        # the flipped reference batch, without dropout, un-flipped landmarks and target
        ref_clip_f = torch.flip(batch["ref_clip"], dims=[0])
        ref_face01_f = torch.flip(batch["ref_face01"], dims=[0]) if "ref_face01" in batch else None
        cond_rec = model.conditioning(ref_clip_f, batch.get("landmarks"), tar_clip, ref_face01_f)
        _, inters = ddim_sample_train(model, z_hi, t_max, cfg.reconstruct_steps, cond_rec, z_inpaint, mask_lat)
        k = inters.shape[0]
        dec = model.decode_first_stage(inters.reshape((k * b,) + inters.shape[2:]))
        dec = dec.reshape((k, b) + tuple(gt.shape[1:]))
        # the face region from the latent mask, applied in [-1, 1]
        face_region = 1.0 - resize_bilinear(mask_lat, hh, ww, antialias=False)
        arcface = model.conditioner.arcface
        id_feats = lambda img01: safe_l2_normalize(arcface(arcface_preprocess(img01)))
        if ref_face01_f is not None:
            ref01_f = ref_face01_f
        else:
            mean = torch.tensor(CLIP_IMAGE_MEAN, device=dev)
            std = torch.tensor(CLIP_IMAGE_STD, device=dev)
            ref01_f = ref_clip_f * std + mean
        with torch.no_grad():  # the reference's y_feats.detach()
            feats_ref = id_feats(ref01_f)
        idl = 0.0
        for j in range(k):
            f = id_feats((dec[j] * face_region + 1.0) * 0.5)
            idl = idl + (1.0 - (f * feats_ref).sum(dim=-1)).mean()
        idl = idl / k
        loss = loss + cfg.id_loss_weight * idl
        logs["loss_id"] = idl
        if perceptual_fn is not None and cfg.lpips_loss_weight > 0:
            # per intermediate x 3 scales, summed (the reference accumulates)
            lp = 0.0
            for j in range(k):
                for i in range(3):
                    a = adaptive_avg_pool(dec[j], hh // 2**i, ww // 2**i)
                    g = adaptive_avg_pool(gt, hh // 2**i, ww // 2**i)
                    lp = lp + perceptual_fn(a, g).mean()
            loss = loss + cfg.lpips_loss_weight * lp
            logs["loss_lpips"] = lp

    logs["loss"] = loss
    return loss, logs


def _backward(loss: torch.Tensor) -> None:
    if loss.requires_grad:  # a part with no term gives a constant 0
        loss.backward()


def make_train_step(model, optimizer, scheduler=None, cfg: TrainConfig = TrainConfig(),
                    perceptual_fn: Optional[Callable] = None):
    """Returns ``train_step(batch, generator) -> logs``: the loss and its
    gradient, one optimizer step, one scheduler step; the logs are detached
    tensors (no host sync)."""

    def train_step(batch: dict, generator: torch.Generator) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, logs = p_losses_face(model, batch, generator, cfg, perceptual_fn=perceptual_fn)
        _backward(loss)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {key: val.detach() for key, val in logs.items()}

    return train_step


def make_split_train_step(model, optimizer, scheduler=None, cfg: TrainConfig = TrainConfig(),
                          perceptual_fn: Optional[Callable] = None):
    """:func:`make_train_step`'s step as two backward passes, the eps / VLB /
    landmark part and the reconstruction / ID / LPIPS part, whose gradients
    add up in ``.grad`` before the one optimizer step. Each part starts from
    the generator state the step was given, so both make the fused loss's
    draws and their gradients sum to the fused gradient; the generator ends
    where the fused step leaves it. The logs are both parts', ``loss`` their sum."""
    cfg_eps = dataclasses.replace(cfg, loss_parts="eps")
    cfg_rec = dataclasses.replace(cfg, loss_parts="recon")

    def train_step(batch: dict, generator: Optional[torch.Generator]) -> dict:
        optimizer.zero_grad(set_to_none=True)
        state = None if generator is None else generator.get_state()
        loss_a, logs_a = p_losses_face(model, batch, generator, cfg_eps, perceptual_fn=perceptual_fn)
        _backward(loss_a)
        if generator is not None:
            generator.set_state(state)
        loss_b, logs_b = p_losses_face(model, batch, generator, cfg_rec, perceptual_fn=perceptual_fn)
        _backward(loss_b)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        logs = {**logs_a, **logs_b, "loss": logs_a["loss"] + logs_b["loss"]}
        return {key: val.detach() for key, val in logs.items()}

    return train_step
