"""The two timed entry points, recomputed in plain float32.

``VideoSwapReference`` follows ``VideoSwapPipeline.swap_video_frames`` on the
benchmark's operating point (the sequential window loop, recon-free 2-chunk
sampling, FSAI + FGATS at the input blocks, no carry, full-resolution
background round trip): the source's alignment, parse, CLIP input and
landmarks; every frame's alignment and parse; then, per window, RAFT flow,
the three conditionings, VAE encode, DDIM inversion, hooked CFG sampling,
decode, the background round trip and the paste-back. ``swap_window_frames``
recomputes one window from the clip alone, which is what the check compares.

``swap_image_batch`` follows the image core: conditioning, encode of the
inpaint image, CFG DDIM from the benchmark's x_T, decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.align import compute_quad, paste_back, perspective_coefficients, quad_crop
from benchmark.reference.attention import FusionConfig
from benchmark.reference.bisenet import BiSeNet, parse_faces
from benchmark.reference.clip import clip_preprocess
from benchmark.reference.landmarks import LandmarkNet, landmarks_to_vector
from benchmark.reference.masks import TRAIN_REMOVE, inpaint_inputs
from benchmark.reference.raft import RAFT, RAFTConfig
from benchmark.reference.samplers import ddim_invert, ddim_sample, vface_sample
from benchmark.reference.unet import InjectionSpec
from benchmark.reference.warp import resize_bilinear, resize_flow, resize_nearest

RAFT_MAX_PAIRS = 5  # pairs per RAFT call, as the program batches them


@dataclasses.dataclass(frozen=True)
class VideoOptions:
    window: int
    ddim_steps: int
    inversion_steps: int
    cfg_scale: float
    raft_iters: int
    parser_size: int
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    flow_tokens: int = 4096


class VideoSwapReference:
    """The model with BiSeNet, RAFT and the landmark net, float32, on one device."""

    def __init__(self, model, opts: VideoOptions, aux_params: dict):
        self.model, self.opts, self.device = model, opts, model.device
        self.injection = InjectionSpec(
            input_blocks=FusionConfig("flow_fix", split_ratio=opts.split_ratio, flow_alpha=opts.flow_alpha,
                                      flow_tokens=opts.flow_tokens), chunks=2)
        with torch.device(self.device):
            self.bisenet = BiSeNet().eval()
            self.raft = RAFT(RAFTConfig(iters=opts.raft_iters)).eval()
            self.landmark_net = LandmarkNet().eval()
        self.bisenet.load_state_dict(aux_params["bisenet"])
        self.raft.load_state_dict(aux_params["raft"])
        self.landmark_net.load_state_dict(aux_params["landmark"])

    def align_crops(self, frames01):
        """(F, H, W, 3) -> (crops01 (F, S, S, 3), inv_coeffs (F, 8)); a degenerate
        quad takes the previous frame's (frame 0: the whole frame)."""
        s = self.model.cfg.image_size
        quad, qsize = compute_quad(self.landmark_net(frames01))
        quads = np.array(quad.cpu().numpy(), np.float32)
        qs = qsize.cpu().numpy()
        h, w = frames01.shape[1], frames01.shape[2]
        prev = np.asarray([[0.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0], [w - 1.0, 0.0]], np.float32)
        for i in range(quads.shape[0]):
            if qs[i] < 0.02 * min(h, w) or not np.isfinite(quads[i]).all():
                quads[i] = prev
            else:
                prev = quads[i]
        crops = quad_crop(frames01, torch.from_numpy(quads).to(self.device), s)
        corners = np.asarray([[0, 0], [0, s], [s, s], [s, 0]], np.float32)
        coeffs = np.stack([perspective_coefficients(q, corners) for q in quads])
        return crops, torch.from_numpy(coeffs).to(self.device)

    def keep_masks(self, crops01):
        """BiSeNet's class map at the crop size -> keep-masks (F, S, S, 1)."""
        seg = parse_faces(self.bisenet, crops01, size=self.opts.parser_size)
        s = crops01.shape[1]
        seg = resize_nearest(seg, s, s) if seg.shape[1] != s else seg
        return inpaint_inputs(crops01 * 2 - 1, seg, TRAIN_REMOVE)[1]

    def source_inputs(self, source01):
        crop01, _ = self.align_crops(source01[None])
        keep = self.keep_masks(crop01)
        size = self.model.cfg.cond.clip.image_size
        return dict(crop01=crop01, keep=keep, clip=clip_preprocess(crop01 * (1.0 - keep), size),
                    lm=landmarks_to_vector(self.landmark_net(crop01)))

    def flow(self, crops01):
        x = crops01 * 2.0 - 1.0
        n = x.shape[0] - 1
        return torch.cat([self.raft(x[i + 1:i + RAFT_MAX_PAIRS + 1], x[i:min(i + RAFT_MAX_PAIRS, n)])
                          for i in range(0, n, RAFT_MAX_PAIRS)], dim=0)

    def conditionings(self, crops, keep, src):
        model, f = self.model, crops.shape[0]
        size = model.cfg.cond.clip.image_size
        crops01 = (crops + 1.0) * 0.5
        lm = landmarks_to_vector(self.landmark_net(crops01))
        tar_clip = clip_preprocess(crops01, size)
        cond = model.conditioning(src["clip"].expand(f, -1, -1, -1), lm, tar_clip,
                                  src["crop01"].expand(f, -1, -1, -1))
        bg01 = crops01 * keep
        inverse_cond = model.conditioning(clip_preprocess(bg01, size), lm, tar_clip, bg01)
        return cond, model.uncond(f), inverse_cond

    def swap_window(self, crops, keep, cond, uncond, inverse_cond, flow):
        """One window's crops in [-1, 1] -> swapped crops in [0, 1]."""
        model, opts, f = self.model, self.opts, crops.shape[0]
        hl = model.cfg.latent_size
        z_inpaint = model.encode_first_stage(crops * keep)
        mask_lat = resize_bilinear(keep, hl, hl)
        z_tar = model.encode_first_stage(crops)
        skip = 1 if opts.inversion_steps >= 2 else 0
        inv_latents = ddim_invert(model, z_tar, inverse_cond, z_inpaint, mask_lat, opts.inversion_steps, skip)
        lat_flow = None if flow is None else resize_flow(flow, hl, hl)
        z0 = vface_sample(model, inv_latents[-1], cond, uncond, z_inpaint, mask_lat, self.injection, lat_flow,
                          opts.ddim_steps, opts.cfg_scale)
        return torch.clamp((model.decode_first_stage(z0) + 1.0) * 0.5, 0.0, 1.0)

    def background(self, frames01):
        out = self.model.decode_first_stage(self.model.encode_first_stage(frames01 * 2.0 - 1.0))
        return torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def swap_window_frames(self, frames01, source01, start: int) -> torch.Tensor:
        """The swapped frames (F, H, W, 3) of the window that starts at frame
        ``start`` of the clip ``frames01`` (N, H, W, 3), with the source image
        ``source01`` (H', W', 3)."""
        src = self.source_inputs(source01)
        crops01, coeffs = self.align_crops(frames01)
        sl = slice(start, min(start + self.opts.window, frames01.shape[0]))
        crops01, coeffs, frames01 = crops01[sl], coeffs[sl], frames01[sl]
        keep = self.keep_masks(crops01)
        flow = self.flow(crops01) if crops01.shape[0] > 1 else None
        crops = crops01 * 2 - 1
        cond, uncond, inverse_cond = self.conditionings(crops, keep, src)
        swapped = self.swap_window(crops, keep, cond, uncond, inverse_cond, flow)
        return paste_back(self.background(frames01), swapped, coeffs, 1.0 - keep)


@torch.inference_mode()
def swap_image_batch(model, target, keep_mask, src_clip, src_face01, landmarks136, x_T, ddim_steps: int,
                     cfg_scale: float) -> torch.Tensor:
    """Swapped crops (B, S, S, 3) in [0, 1] from x_T (B, h, w, 4)."""
    hl = model.cfg.latent_size
    tar_clip = clip_preprocess((target + 1.0) * 0.5, model.cfg.cond.clip.image_size)
    cond = model.conditioning(src_clip, landmarks136, tar_clip, src_face01)
    uncond = model.uncond(target.shape[0])
    z_inpaint = model.encode_first_stage(target * keep_mask)
    mask_lat = resize_bilinear(keep_mask, hl, hl)
    z0 = ddim_sample(model, x_T, cond, uncond, z_inpaint, mask_lat, ddim_steps, cfg_scale)
    return torch.clamp((model.decode_first_stage(z0) + 1.0) * 0.5, 0.0, 1.0)
