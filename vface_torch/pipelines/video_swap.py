"""The VFace video swap, one window at a time: the device core of the pipeline.

Port of ``vface_tpu/pipelines/video_swap.py`` limited to ``SwapOptions`` and
``VideoSwapPipeline.swap_window`` (the semantics of ``_swap_window_impl``):

1. VAE encode of the target crops and of the masked inpaint image, and the
   keep-mask resized to the latent grid;
2. DDIM inversion of the target latents (``skip_last=1`` in the recon-free
   mode: only the t=961 start code is consumed);
3. hooked CFG sampling (FSAI + FGATS at the input-block attn1 sites) from the
   start code, 2-chunk unless ``keep_recon_chunk``;
4. VAE decode and a clip to [0, 1].

Conditioning embeddings, keep-masks and flow come in precomputed; the aux
nets (landmarks, parser, RAFT, conditioner), paste-back and the per-video
frame loops are not ported yet. The source is only encoded when
``co_invert_source`` asks for the literal co-inverted batch (eager PyTorch
would otherwise run two dead 512^2 encodes per window).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from vface_torch.models.ldm import VFaceModel
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.ops.warp import resize_bilinear, resize_flow
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import vface_sample
from vface_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class SwapOptions:
    """Operating point of the reference's batch video swap (eta = 0)."""

    ddim_steps: int = 50
    inversion_steps: int = 50
    cfg_scale: float = 3.0
    window: int = 6  # frames per window
    image_size: int = 512
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    # literal reference inversion batch cat([target, source]); the source
    # half is never consumed, so it is off by default
    co_invert_source: bool = False
    # literal 3-chunk sampling batch; the recon chunk is inert, so off by default
    keep_recon_chunk: bool = False
    # token count at which FGATS applies (4096 = the 64x64 grid at 512px)
    flow_tokens: int = 4096


class VideoSwapPipeline:
    """The diffusion model plus the window op, on one device (CUDA unless asked otherwise)."""

    def __init__(self, model: VFaceModel, opts: SwapOptions = SwapOptions(), device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, pipeline asked for {self.device}")
        self.model = model
        self.opts = opts
        self.injection = InjectionSpec(
            input_blocks=FusionConfig("flow_fix", split_ratio=opts.split_ratio,
                                      flow_alpha=opts.flow_alpha, flow_tokens=opts.flow_tokens),
            chunks=3,
        )

    @torch.inference_mode()
    def swap_window(self, crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop,
                    src_keep_mask, flow: Optional[torch.Tensor] = None,
                    timings: Optional[dict] = None) -> torch.Tensor:
        """One window -> swapped crops (F, S, S, 3) in [0, 1].

        crops (F, S, S, 3) in [-1, 1]; keep_mask (F, S, S, 1), 1 = background
        kept; cond / uncond / inverse_cond / cond_w_src (F, 1, D); src_crop
        (1, S, S, 3) in [-1, 1]; src_keep_mask (1, S, S, 1); flow (F-1, S, S, 2)
        in pixels or None. With ``timings`` (a dict) the device is synchronised
        at each stage boundary and the wall seconds of encode, invert, sample
        and decode are stored in it.
        """
        opts, model = self.opts, self.model
        dev = self.device
        args = [crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask, flow]
        (crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask,
         flow) = [None if a is None else torch.as_tensor(a).to(dev) for a in args]
        f = crops.shape[0]
        hl = model.cfg.latent_size
        clock = _StageClock(timings, dev)

        z_inpaint = model.encode_first_stage(crops * keep_mask)
        mask_lat = resize_bilinear(keep_mask, hl, hl)
        z_tar = model.encode_first_stage(crops)
        if opts.co_invert_source:
            bcast = lambda t: t.expand((f,) + t.shape[1:])
            z_src = model.encode_first_stage(bcast(src_crop))
            z_inpaint_src = model.encode_first_stage(bcast(src_crop * src_keep_mask))
            src_mask_lat = resize_bilinear(bcast(src_keep_mask), hl, hl)
            z2 = torch.cat([z_tar, z_src], dim=0)
            inv_c = torch.cat([inverse_cond, cond_w_src], dim=0)
            inv_inpaint = torch.cat([z_inpaint, z_inpaint_src], dim=0)
            inv_mask = torch.cat([mask_lat, src_mask_lat], dim=0)
        else:
            z2, inv_c, inv_inpaint, inv_mask = z_tar, inverse_cond, z_inpaint, mask_lat
        clock.mark("encode")

        skip = 1 if (not opts.keep_recon_chunk and opts.inversion_steps >= 2) else 0
        _, inv_latents = ddim_invert(model, z2, inv_c, inv_inpaint, inv_mask,
                                     num_steps=opts.inversion_steps, keep=f, skip_last=skip)
        if skip or opts.inversion_steps < 2:
            start_code = inv_latents[-1]
        else:
            start_code = inv_latents[-2]  # t = 961 for S = 50 (timesteps end at 981)
        clock.mark("invert")

        flow_q = None if flow is None else resize_flow(flow, hl, hl)
        z0, _ = vface_sample(model, start_code, cond, uncond, inverse_cond, inv_latents, z_inpaint,
                             mask_lat, self.injection, flow=flow_q, num_steps=opts.ddim_steps,
                             cfg_scale=opts.cfg_scale, drop_recon_chunk=not opts.keep_recon_chunk)
        clock.mark("sample")

        out = model.decode_first_stage(z0)
        out01 = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
        clock.mark("decode")
        return out01


class _StageClock:
    """Wall seconds per stage, device-synchronised; a no-op without a target dict."""

    def __init__(self, target: Optional[dict], device: torch.device):
        self.target, self.device = target, device
        self.t = self._now() if target is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.target is None:
            return
        now = self._now()
        self.target[stage] = now - self.t
        self.t = now
