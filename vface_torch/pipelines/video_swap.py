"""The VFace video face swap: align, parse, flow, conditionings, windows, paste-back.

Port of ``vface_tpu/pipelines/video_swap.py``'s single-device paths:

* :class:`SwapOptions`, the operating point;
* :class:`VideoSwapPipeline`, the diffusion model with the aux nets (BiSeNet,
  RAFT, LandmarkNet) on one device, and its stages: ``detect_landmarks``,
  ``align_begin`` / ``align_finish`` (the host fallback for degenerate quads)
  / ``align_crops``, ``parse_masks``, ``compute_flow`` /
  ``compute_flow_superpack``, ``window_conditionings``, ``swap_window`` (the
  window core: ``_swap_window_impl``'s semantics), ``swap_window_pasted``
  with ``decode_with_background``, and ``swap_video_frames``, the window loop
  with its schedulers.

The window core: VAE encode of the target crops and of the masked inpaint
image; DDIM inversion (``skip_last=1`` in the recon-free mode: only the t=961
start code is consumed); hooked CFG sampling (FSAI + FGATS at the input-block
attn1 sites), 2-chunk unless ``keep_recon_chunk``; VAE decode and a clip to
[0, 1]. The source is only encoded when ``co_invert_source`` asks for the
literal co-inverted batch.

The window loop steps over packs of ``window * batch_windows`` frames (the
FGATS blend masked at each window boundary inside a pack, so the frames equal
separate windows'). With ``cross_window_carry`` each window's first frame
blends with the previous window's last frame's attention state. Where the
JAX package's eligibility tests pass, a scheduler replaces the loop, each
giving the loop's frames:

* ``pipeline_packs``: pack i+1's inversion rides pack i's sampling evals as
  bystander rows (b = 2F + G), after a prologue inversion of pack 0 and
  before a sampling-only epilogue;
* ``invert_packs=2`` (the super-pack): two packs' inversions in one b = 2F
  scan, their samplings at b = 2F each, or as one b = 4F scan with
  ``merge_sampling`` (the pack boundary pair-masked), the VAE stages per pack;
  on numpy frames the streaming form prepares group i+1 (upload through
  pinned memory, alignment, parse, conditionings, flow) before super-pack i.

With a ``manifest`` and a ``window_sink`` a run is resumable: packs the
manifest lists are read back from the sink's PNGs, and each computed pack is
handed to the sink and marked done in pack order on a worker thread while the
next one runs.

``eta > 0`` draws each sampler call's noise from the pipeline's noise source
(``noise``; by default a generator seeded with 0 afresh on each call, as the
JAX package draws from ``PRNGKey(0)`` on each call); ``encoder_interval > 1``
runs encoder propagation in the inversion and the sampling (not with
``cross_window_carry``, which the JAX package refuses as well).

:func:`swap_video_frames_multiface` swaps up to ``top_k`` faces a frame: the
face detector (``aux_params["detector"]``) finds them, and each face's
landmarks, found in its box crop, drive :meth:`VideoSwapPipeline.swap_video_frames`.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from vface_torch.io.image import read_png
from vface_torch.models.bisenet import BiSeNet, parse_faces
from vface_torch.models.clip import clip_preprocess
from vface_torch.models.ldm import VFaceModel
from vface_torch.models.raft import RAFT, RAFTConfig
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.ops.warp import resize_bilinear, resize_flow, resize_nearest
from vface_torch.preprocess.align import compute_quad, paste_back, perspective_coefficients, quad_crop
from vface_torch.preprocess.detector import FaceDetector, crop_boxes, decode_detections
from vface_torch.preprocess.landmarks import LandmarkNet, landmarks_to_vector
from vface_torch.preprocess.masks import TRAIN_REMOVE, inpaint_inputs
from vface_torch.samplers.ddim import NoiseFn
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import vface_sample, vface_sample_pipelined
from vface_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class SwapOptions:
    """Operating point of the reference's batch video swap."""

    ddim_steps: int = 50
    inversion_steps: int = 50
    cfg_scale: float = 3.0
    window: int = 6  # frames per window
    image_size: int = 512
    parser_size: int = 512  # BiSeNet input resolution
    eta: float = 0.0  # > 0 adds noise each sampling step (the pipeline's noise source)
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    # literal reference inversion batch cat([target, source]); the source
    # half is never consumed, so it is off by default
    co_invert_source: bool = False
    # literal 3-chunk sampling batch; the recon chunk is inert, so off by default
    keep_recon_chunk: bool = False
    # encoder propagation: the full UNet on key steps only (1 = exact; the
    # other steps reuse the last key step's encoder and middle block)
    encoder_interval: int = 1
    # the FGATS carry across windows: each window's frame 0 blends with the
    # previous window's last frame (sequential loop only; experimental in the
    # JAX package, whose benefit needs trained weights to show)
    cross_window_carry: bool = False
    # pack this many consecutive windows into one call, the FGATS blend masked
    # at the window boundaries (the frames equal separate windows')
    batch_windows: int = 1
    # token count at which FGATS applies (4096 = the 64x64 grid at 512px)
    flow_tokens: int = 4096
    # the schedulers (each gives the sequential loop's frames): pack i+1's
    # inversion on pack i's sampling evals (b = 2F + G)
    pipeline_packs: bool = False
    # 2: two packs' inversions in one b = 2F scan (the super-pack)
    invert_packs: int = 1
    # with invert_packs=2: both packs' sampling as one b = 4F scan
    merge_sampling: bool = False
    raft_iters: int = 20  # RAFT GRU iterations (the reference pins 20)
    # background-trick resolution: 0 = full resolution (exact); r > 0 runs
    # the VAE round trip at r^2 and upsamples (only background pixels change)
    background_res: int = 0


_AUX = {"bisenet": "bisenet", "raft": "raft", "landmark": "landmark_net", "detector": "detector"}
# At 6 or more pairs of 512^2 crops, cuDNN's heuristics give RAFT's update
# block (64^2 maps) an FFT-tiled convolution launched tile by tile: 432.7 and
# 343.6 ms a pair at 6 and 11 pairs against 45.1 at 5 (an H100 80GB HBM3;
# chip_smoke.py's cli_flow_batch line, PERF.md §6)
RAFT_MAX_PAIRS = 5


class VideoSwapPipeline:
    """The diffusion model plus the aux nets and the window ops, on one device
    (CUDA unless asked otherwise). The aux nets' parameters come from
    ``aux_params`` (``{"bisenet", "raft", "landmark", "detector"}`` state
    dicts, any subset, each loaded strictly; e.g. from
    :func:`vface_torch.utils.convert.from_flax_aux` or ``init_aux_params``); a
    stage whose net has none raises. ``swap_window`` needs neither; the video
    path needs them and a model built with ``conditioner=True``. ``noise``
    is the samplers' noise source for ``eta > 0``, ``noise(step_idx, shape)
    -> Tensor``, handed to every sampler call (None: each call seeds its own
    generator with 0)."""

    def __init__(self, model: VFaceModel, opts: SwapOptions = SwapOptions(), device="cuda",
                 aux_params: Optional[dict] = None, noise: Optional[NoiseFn] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, pipeline asked for {self.device}")
        self.model = model
        self.opts = opts
        self.noise = noise
        self.injection = InjectionSpec(
            input_blocks=FusionConfig("flow_fix", split_ratio=opts.split_ratio,
                                      flow_alpha=opts.flow_alpha, flow_tokens=opts.flow_tokens),
            chunks=3,
        )
        with torch.device(self.device):
            self.bisenet = BiSeNet().eval()
            self.raft = RAFT(RAFTConfig(iters=opts.raft_iters)).eval()
            self.landmark_net = LandmarkNet().eval()
            self.detector = FaceDetector().eval()
        for name, state in (aux_params or {}).items():
            getattr(self, _AUX[name]).load_state_dict(state)
        self._loaded = set(aux_params or ())
        self.fallback_frames = 0  # target frames whose quad fell back in the last align_crops

    def _net(self, name: str) -> torch.nn.Module:
        if name not in self._loaded:
            raise ValueError(f"VideoSwapPipeline: no {name!r} parameters (pass them in aux_params)")
        return getattr(self, _AUX[name])

    def _on(self, x) -> torch.Tensor:
        """x (a tensor or an array) as float32 on the pipeline's device."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    # ---------------------------------------------------------------- prep
    @torch.inference_mode()
    def detect_landmarks(self, images01) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, 68, 2) pixel coordinates."""
        return self._net("landmark")(self._on(images01))

    @torch.inference_mode()
    def detect_faces(self, images01, top_k: int = 2):
        """(B, H, W, 3) in [0, 1] -> boxes (B, K, 4) [cx, cy, w, h] in frame
        pixels and scores (B, K), the K highest peaks of the face detector."""
        images01 = self._on(images01)
        heat, size, offset = self._net("detector")(images01)
        return decode_detections(heat, size, offset, top_k=top_k, image_hw=tuple(images01.shape[1:3]))

    @torch.inference_mode()
    def align_begin(self, frames01, scale: float = 1.0, landmarks=None):
        """Landmark detection and the quads: (quad (F, 4, 2), qsize (F,)) on the device."""
        lm = self._on(landmarks) if landmarks is not None else self.detect_landmarks(frames01)
        return compute_quad(lm, scale=scale)

    @torch.inference_mode()
    def align_finish(self, frames01, quad, qsize, prev_quad: Optional[np.ndarray] = None):
        """The host tail of the alignment: a degenerate quad (near-zero extent or
        not finite) reuses the previous frame's quad, frame 0 a quad of the
        whole frame; then the crop and the inverse-perspective solve. Returns
        (crops01, inv_coeffs, last_quad); ``self.fallback_frames`` counts the
        frames that fell back."""
        s = self.opts.image_size
        frames01 = self._on(frames01)
        quads = np.array(quad.cpu().numpy() if isinstance(quad, torch.Tensor) else quad, np.float32)
        qs = np.asarray(qsize.cpu().numpy() if isinstance(qsize, torch.Tensor) else qsize)
        h_img, w_img = frames01.shape[1], frames01.shape[2]
        min_q = 0.02 * min(h_img, w_img)
        prev = np.asarray([[0.0, 0.0], [0.0, h_img - 1.0], [w_img - 1.0, h_img - 1.0], [w_img - 1.0, 0.0]],
                          np.float32) if prev_quad is None else prev_quad
        fell = 0
        for i in range(quads.shape[0]):
            if qs[i] < min_q or not np.isfinite(quads[i]).all():
                quads[i] = prev
                fell += 1
            else:
                prev = quads[i]
        self.fallback_frames = fell
        crops = quad_crop(frames01, torch.from_numpy(quads).to(self.device), s)
        corners = np.asarray([[0, 0], [0, s], [s, s], [s, 0]], np.float32)
        coeffs = np.stack([perspective_coefficients(q, corners) for q in quads])
        return crops, torch.from_numpy(coeffs).to(self.device), prev

    def align_crops(self, frames01, scale: float = 1.0, landmarks=None):
        """frames01 (F, H, W, 3) in [0, 1] -> (crops01 (F, S, S, 3), inv_coeffs (F, 8));
        ``landmarks`` (F, 68, 2) replaces detection."""
        quad, qsize = self.align_begin(frames01, scale, landmarks)
        crops, coeffs, _ = self.align_finish(frames01, quad, qsize)
        return crops, coeffs

    @torch.inference_mode()
    def parse_masks(self, crops01) -> torch.Tensor:
        """Class map (F, S, S) int32 at the crop size: BiSeNet at ``parser_size``,
        the map resized back with JAX's nearest (half-pixel centres)."""
        crops01 = self._on(crops01)
        seg = parse_faces(self._net("bisenet"), crops01, size=self.opts.parser_size)
        s = crops01.shape[1]
        return resize_nearest(seg, s, s) if seg.shape[1] != s else seg

    @torch.inference_mode()
    def compute_flow(self, crops01) -> torch.Tensor:
        """(F, S, S, 3) -> (F-1, S, S, 2): flow[i] = RAFT(x[i+1], x[i]), the backward
        flow on frame i+1's grid mapping to frame i (the argument order is
        load-bearing: ``align_by_flow`` samples frame i at grid + flow[i]).
        RAFT runs on at most ``RAFT_MAX_PAIRS`` pairs at a time (the pairs are
        independent)."""
        x = self._on(crops01) * 2.0 - 1.0
        raft = self._net("raft")
        n = x.shape[0] - 1
        return torch.cat([raft(x[i + 1:i + RAFT_MAX_PAIRS + 1], x[i:min(i + RAFT_MAX_PAIRS, n)])
                          for i in range(0, n, RAFT_MAX_PAIRS)], dim=0)

    def compute_flow_superpack(self, crops01) -> Optional[torch.Tensor]:
        """The flow of a super-pack's 2F frames, per pack: (2F-1, S, S, 2) with
        the pack boundary's slot zero (no pack reads it); None for 1-frame packs."""
        f = crops01.shape[0] // 2
        if f < 2:
            return None
        fa, fb = self.compute_flow(crops01[:f]), self.compute_flow(crops01[f:])
        return torch.cat([fa, torch.zeros_like(fa[:1]), fb], dim=0)

    # ------------------------------------------------------- conditionings
    @torch.inference_mode()
    def window_conditionings(self, crops, keep_mask, src_clip, src_crop01, src_landmarks):
        """(cond, uncond, inverse_cond, cond_w_src), each (F, 1, D), for a window.

        crops (F, S, S, 3) in [-1, 1]; keep_mask (F, S, S, 1); src_clip (1, 224,
        224, 3) the CLIP-normalised masked source; src_crop01 (1, S, S, 3);
        src_landmarks (1, 136)."""
        model = self.model
        if model.conditioner is None:
            raise ValueError("VideoSwapPipeline: the video path needs a model built with conditioner=True")
        crops, keep_mask, src_clip, src_crop01, src_landmarks = map(
            self._on, (crops, keep_mask, src_clip, src_crop01, src_landmarks))
        f = crops.shape[0]
        size = model.cfg.cond.clip.image_size
        crops01 = (crops + 1.0) * 0.5
        lm = landmarks_to_vector(self.detect_landmarks(crops01))
        tar_clip = clip_preprocess(crops01, size)
        bcast = lambda t: t.expand((f,) + t.shape[1:])
        # swap: CLIP(source) + CLIP(target frame) + ID(source) + landmarks(target)
        cond = model.conditioning(bcast(src_clip), lm, tar_clip, bcast(src_crop01))
        # inversion: CLIP(masked target) + CLIP(target) + ID(masked target) + landmarks(target)
        bg01 = crops01 * keep_mask
        inverse_cond = model.conditioning(clip_preprocess(bg01, size), lm, tar_clip, bg01)
        # source reconstruction (the co-inverted source chunk)
        cond_w_src = model.conditioning(src_clip, src_landmarks, clip_preprocess(src_crop01, size), src_crop01)
        return cond, model.uncond(f), inverse_cond, bcast(cond_w_src)

    # ------------------------------------------------------------- window
    def _encode_pack(self, crops, keep_mask):
        """(z_tar, z_inpaint, mask_lat) of one pack: crops (F, S, S, 3) in [-1, 1], keep_mask (F, S, S, 1)."""
        hl = self.model.cfg.latent_size
        z_inpaint = self.model.encode_first_stage(crops * keep_mask)
        mask_lat = resize_bilinear(keep_mask, hl, hl)
        z_tar = self.model.encode_first_stage(crops)
        return z_tar, z_inpaint, mask_lat

    def _latent_flow(self, flow):
        """A pixel flow resized to the ds1 token grid, or None."""
        hl = self.model.cfg.latent_size
        return None if flow is None else resize_flow(self._on(flow), hl, hl)

    def _decode01(self, z) -> torch.Tensor:
        return torch.clamp((self.model.decode_first_stage(z) + 1.0) * 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def swap_window(self, crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop,
                    src_keep_mask, flow: Optional[torch.Tensor] = None,
                    timings: Optional[dict] = None, pair_mask=None, fgats_prev: Optional[dict] = None,
                    fgats_flow0: Optional[torch.Tensor] = None, return_fgats: bool = False):
        """One window (or a pack of windows) -> swapped crops (F, S, S, 3) in [0, 1].

        crops (F, S, S, 3) in [-1, 1]; keep_mask (F, S, S, 1), 1 = background
        kept; cond / uncond / inverse_cond / cond_w_src (F, 1, D); src_crop
        (1, S, S, 3) in [-1, 1]; src_keep_mask (1, S, S, 1); flow (F-1, S, S, 2)
        in pixels or None; pair_mask (F-1,) or None, with a flow: 0 turns off
        the FGATS blend of pair (i, i+1) (a window boundary inside a pack).
        The cross-window carry: ``fgats_prev``, the previous window's per-step
        carry stack, and ``fgats_flow0`` (1, S, S, 2), the pixel flow from
        this window's frame 0 back to the previous window's last frame;
        ``return_fgats`` returns (crops, this window's carry stack). With
        ``timings`` (a dict) the device is synchronised at each stage boundary
        and the wall seconds of encode, invert, sample and decode are added
        to it.
        """
        opts, model = self.opts, self.model
        args = [crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask, pair_mask]
        (crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask,
         pair_mask) = [None if a is None else self._on(a) for a in args]
        f = crops.shape[0]
        hl = model.cfg.latent_size
        clock = StageClock(timings, self.device)

        z_tar, z_inpaint, mask_lat = self._encode_pack(crops, keep_mask)
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
        _, inv_latents = ddim_invert(model, z2, inv_c, inv_inpaint, inv_mask, num_steps=opts.inversion_steps,
                                     keep=f, encoder_interval=opts.encoder_interval, skip_last=skip)
        if skip or opts.inversion_steps < 2:
            start_code = inv_latents[-1]
        else:
            start_code = inv_latents[-2]  # t = 961 for S = 50 (timesteps end at 981)
        clock.mark("invert")

        res = vface_sample(model, start_code, cond, uncond, inverse_cond, inv_latents, z_inpaint, mask_lat,
                           self.injection, flow=self._latent_flow(flow), num_steps=opts.ddim_steps,
                           cfg_scale=opts.cfg_scale, eta=opts.eta, noise=self.noise,
                           encoder_interval=opts.encoder_interval, drop_recon_chunk=not opts.keep_recon_chunk,
                           fgats_prev=fgats_prev, fgats_flow0=self._latent_flow(fgats_flow0),
                           return_fgats_carry=return_fgats, flow_pair_mask=pair_mask)
        clock.mark("sample")

        out01 = self._decode01(res[0])
        clock.mark("decode")
        return (out01, res[2]) if return_fgats else out01

    @torch.inference_mode()
    def decode_with_background(self, frames) -> torch.Tensor:
        """The background-consistency trick: a VAE encode + decode of the
        original frames (in [-1, 1]), so pasted backgrounds share the VAE's
        colour response; -> [0, 1]. ``background_res`` r > 0 runs the round
        trip at r^2 (antialiased downsample) and resizes back bilinearly to
        the frames' (H, W). On square frames this is the JAX package's trick;
        on non-square ones JAX resizes back to (H, H), which its paste-back
        cannot take (ROADMAP C)."""
        frames = self._on(frames)
        r = self.opts.background_res
        h, w = frames.shape[1], frames.shape[2]
        if r and r < h:
            out = self.model.decode_first_stage(self.model.encode_first_stage(resize_bilinear(frames, r, r)))
            out = resize_bilinear(out, h, w)
        else:
            out = self.model.decode_first_stage(self.model.encode_first_stage(frames))
        return torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)

    def _paste(self, frames01_w, inv_coeffs_w, keep_mask, swapped, clock) -> torch.Tensor:
        """The background trick on the original frames and the paste-back of the swapped crops."""
        bg = self.decode_with_background(self._on(frames01_w) * 2.0 - 1.0)
        clock.mark("background")
        pasted = paste_back(bg, swapped, self._on(inv_coeffs_w), 1.0 - keep_mask)
        clock.mark("paste_back")
        return pasted

    @torch.inference_mode()
    def swap_window_pasted(self, frames01_w, inv_coeffs_w, crops, keep_mask, cond, uncond, inverse_cond,
                           cond_w_src, src_crop, src_keep_mask, flow=None,
                           timings: Optional[dict] = None, pair_mask=None, fgats_prev: Optional[dict] = None,
                           fgats_flow0=None, return_fgats: bool = False):
        """:meth:`swap_window`, the background trick on the window's original
        frames (F, H, W, 3) in [0, 1], and the paste-back of the swapped crops
        through ``inv_coeffs_w`` (F, 8) with the face region (1 - keep_mask) as
        the mask -> (F, H, W, 3) in [0, 1] (and the carry stack with
        ``return_fgats``); ``timings`` adds "background" and "paste_back" to
        the window's stages."""
        keep_mask = self._on(keep_mask)
        res = self.swap_window(crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop,
                               src_keep_mask, flow, timings=timings, pair_mask=pair_mask, fgats_prev=fgats_prev,
                               fgats_flow0=fgats_flow0, return_fgats=return_fgats)
        swapped = res[0] if return_fgats else res
        pasted = self._paste(frames01_w, inv_coeffs_w, keep_mask, swapped, StageClock(timings, self.device))
        return (pasted, res[1]) if return_fgats else pasted

    # ---------------------------------------------------- pipelined packs
    def _invert_pack(self, crops, keep_mask, inverse_cond, timings=None):
        """The pipelined packs' prologue: encode and invert pack 0 -> (start
        code, z_inpaint, mask_lat); recon-free, so ``skip_last=1``."""
        clock = StageClock(timings, self.device)
        z_tar, z_inpaint, mask_lat = self._encode_pack(crops, keep_mask)
        clock.mark("encode")
        x_T, _ = ddim_invert(self.model, z_tar, inverse_cond, z_inpaint, mask_lat,
                             num_steps=self.opts.inversion_steps, keep=1, skip_last=1)
        clock.mark("invert")
        return x_T, z_inpaint, mask_lat

    def _pipelined_step(self, frames01_i, inv_coeffs_i, keep_i, start_i, z_inpaint_i, mask_lat_i, cond_i,
                        uncond_i, flow_i, pair_mask_i, crops_next, keep_next, inv_cond_next, timings=None):
        """The steady state: sample pack i while pack i+1's inversion rides
        the same UNet evals as bystander rows, then decode, the background
        trick and the paste-back of pack i -> (pasted, pack i+1's start code,
        z_inpaint, mask_lat)."""
        opts = self.opts
        clock = StageClock(timings, self.device)
        z_tar_n, z_inp_n, ml_n = self._encode_pack(crops_next, keep_next)
        clock.mark("encode")
        z0, _, start_next = vface_sample_pipelined(
            self.model, start_i, cond_i, uncond_i, z_inpaint_i, mask_lat_i, self.injection, next_z0=z_tar_n,
            next_cond=inv_cond_next, next_inpaint=z_inp_n, next_mask=ml_n, inversion_steps=opts.inversion_steps,
            skip_last=1, flow=self._latent_flow(flow_i), num_steps=opts.ddim_steps, cfg_scale=opts.cfg_scale,
            eta=opts.eta, noise=self.noise, flow_pair_mask=None if pair_mask_i is None else self._on(pair_mask_i))
        clock.mark("pipelined")
        out01 = self._decode01(z0)
        clock.mark("decode")
        return self._paste(frames01_i, inv_coeffs_i, keep_i, out01, clock), start_next, z_inp_n, ml_n

    def _final_pack(self, frames01_i, inv_coeffs_i, keep_i, start_i, z_inpaint_i, mask_lat_i, cond_i, uncond_i,
                    flow_i, pair_mask_i, timings=None):
        """The epilogue: sampling only for the last pack (no inversion rides it)."""
        opts = self.opts
        clock = StageClock(timings, self.device)
        z0, _ = vface_sample(self.model, start_i, cond_i, uncond_i, cond_i, None, z_inpaint_i, mask_lat_i,
                             self.injection, flow=self._latent_flow(flow_i), num_steps=opts.ddim_steps,
                             cfg_scale=opts.cfg_scale, eta=opts.eta, noise=self.noise, drop_recon_chunk=True,
                             flow_pair_mask=None if pair_mask_i is None else self._on(pair_mask_i))
        clock.mark("sample")
        out01 = self._decode01(z0)
        clock.mark("decode")
        return self._paste(frames01_i, inv_coeffs_i, keep_i, out01, clock)

    # --------------------------------------------------------- super-pack
    def _superpack(self, frames01_2, inv_coeffs_2, crops_2, keep_2, cond_2, uncond_2, inv_cond_2, flow_2,
                   timings=None) -> torch.Tensor:
        """Two packs (2F frames) at once: one b = 2F inversion scan, then each
        pack's 2-chunk sampling at b = 2F, or both as one b = 4F scan with
        ``merge_sampling`` (the FGATS blend masked at the pack boundary, whose
        flow slot ``compute_flow_superpack`` leaves zero, as at a window
        boundary). The VAE stages run per pack, at b = F, which keeps the 512^2
        VAE's peak at one pack's. The packs' frames equal two separate packs':
        batch rows are independent and each pack blends only its own pairs."""
        opts, model = self.opts, self.model
        f = crops_2.shape[0] // 2
        clock = StageClock(timings, self.device)

        def per_half(fn, *xs):
            outs = [fn(*(x[h * f:(h + 1) * f] for x in xs)) for h in (0, 1)]
            if isinstance(outs[0], tuple):
                return tuple(torch.cat(parts) for parts in zip(*outs))
            return torch.cat(outs)

        z_tar, z_inpaint, mask_lat = per_half(self._encode_pack, crops_2, keep_2)
        clock.mark("encode")
        x_T, _ = ddim_invert(model, z_tar, inv_cond_2, z_inpaint, mask_lat, num_steps=opts.inversion_steps, keep=1,
                             encoder_interval=opts.encoder_interval, skip_last=1)
        clock.mark("invert")
        flow_q = self._latent_flow(flow_2)

        def sample(sl, flow, pair_mask):
            pm = None if pair_mask is None or flow is None else self._on(pair_mask)
            return vface_sample(model, x_T[sl], cond_2[sl], uncond_2[sl], cond_2[sl], None, z_inpaint[sl],
                                mask_lat[sl], self.injection, flow=flow, num_steps=opts.ddim_steps,
                                cfg_scale=opts.cfg_scale, eta=opts.eta, noise=self.noise,
                                encoder_interval=opts.encoder_interval, drop_recon_chunk=True, flow_pair_mask=pm)[0]

        if opts.merge_sampling:
            z0 = sample(slice(None), flow_q, pack_pair_mask(2 * f, opts.window))
        else:
            pm = pack_pair_mask(f, opts.window)
            halves = (None, None) if flow_q is None else (flow_q[:f - 1], flow_q[f:])
            z0 = torch.cat([sample(slice(0, f), halves[0], pm), sample(slice(f, 2 * f), halves[1], pm)])
        clock.mark("sample")
        out01 = per_half(self._decode01, z0)
        clock.mark("decode")
        bg = per_half(lambda fr: self.decode_with_background(fr * 2.0 - 1.0), self._on(frames01_2))
        clock.mark("background")
        pasted = paste_back(bg, out01, self._on(inv_coeffs_2), 1.0 - keep_2)
        clock.mark("paste_back")
        return pasted

    @staticmethod
    def _coerce_keep(keep, crops_shape) -> torch.Tensor:
        """Precomputed keep masks -> (N, S, S, 1) float32 at the crop size (nearest:
        the masks are binary)."""
        keep = (keep.to(torch.float32) if isinstance(keep, torch.Tensor)
                else torch.from_numpy(np.array(keep, dtype=np.float32)))
        if keep.ndim == 3:
            keep = keep[..., None]
        n, s = crops_shape[0], crops_shape[1]
        if keep.shape[1] != s or keep.shape[2] != s:
            keep = resize_nearest(keep, s, s)
        if keep.shape[0] != n:
            raise ValueError(f"frame_keep has {keep.shape[0]} masks for {n} frames")
        return keep

    # ------------------------------------------------------------ full run
    def _source_inputs(self, source01, source_keep, remove_classes, clock) -> dict:
        """The aligned source (crop01 (1, S, S, 3)), its keep-mask, the masked,
        CLIP-normalised reference (clip) and its landmarks (lm)."""
        src_crop01, _ = self.align_crops(self._on(source01)[None])
        clock.mark("align")
        if source_keep is not None:
            src_keep = self._coerce_keep(source_keep[None], src_crop01.shape).to(self.device)
        else:
            _, src_keep = inpaint_inputs(src_crop01 * 2 - 1, self.parse_masks(src_crop01), remove_classes)
        clock.mark("parse")
        src_clip = clip_preprocess(src_crop01 * (1.0 - src_keep), self.model.cfg.cond.clip.image_size)
        src_lm = landmarks_to_vector(self.detect_landmarks(src_crop01))
        clock.mark("conditionings")
        return dict(crop01=src_crop01, keep=src_keep, clip=src_clip, lm=src_lm)

    def _pack_inputs(self, crops01, keep_mask, src: dict, clock, flow_fn=None) -> dict:
        """One pack's crops in [-1, 1] (c), keep-masks (km), flow, pair mask (pm,
        at the window boundaries inside a pack) and conditionings; ``flow_fn``
        replaces :meth:`compute_flow`."""
        nf = crops01.shape[0]
        c = crops01 * 2 - 1
        flow = (flow_fn or self.compute_flow)(crops01) if nf > 1 else None
        clock.mark("flow")
        pm = None
        if flow is not None and self.opts.batch_windows > 1 and not self.opts.cross_window_carry:
            pm = pack_pair_mask(nf, self.opts.window)
        cond, uncond, inv_c, c_src = self.window_conditionings(c, keep_mask, src["clip"], src["crop01"], src["lm"])
        clock.mark("conditionings")
        return dict(c=c, km=keep_mask, flow=flow, pm=pm, cond=cond, uncond=uncond, inv_c=inv_c, c_src=c_src)

    def _swap_pack(self, frames01_w, inv_coeffs_w, p: dict, src: dict, timings, **carry):
        """One pack through :meth:`swap_window_pasted`."""
        return self.swap_window_pasted(frames01_w, inv_coeffs_w, p["c"], p["km"], p["cond"], p["uncond"], p["inv_c"],
                                       p["c_src"], src["crop01"] * 2 - 1, src["keep"], p["flow"], timings=timings,
                                       pair_mask=p["pm"], **carry)

    @torch.inference_mode()
    def swap_video_frames(self, frames01, source01, remove_classes=None, manifest=None, window_sink=None,
                          frame_landmarks=None, frame_keep=None, source_keep=None,
                          timings: Optional[dict] = None) -> torch.Tensor:
        """Align, parse, then the window loop (flow, conditionings, window,
        background, paste-back) or a scheduler: frames01 (N, H, W, 3) in [0, 1]
        and source01 (H', W', 3) -> swapped frames (N, H, W, 3) float32 in
        [0, 1], on the CPU.

        ``frame_keep`` / ``source_keep``: precomputed keep masks (1 = background
        kept) in crop space, (N, S, S[, 1]) / (S, S[, 1]); the parse of that
        side is then skipped. ``frame_landmarks`` (N, 68, 2) replaces the
        frames' landmark detection.

        The loop steps over packs of ``window * batch_windows`` frames. The
        schedulers take over where the JAX package's eligibility tests pass
        (checked in its order, on the pack width w): the super-pack with
        ``invert_packs=2`` on at least 2w frames, streamed for numpy frames
        without ``frame_landmarks`` / ``frame_keep``; else the pipelined packs
        with ``pipeline_packs`` on at least w + 1 frames and
        ``inversion_steps <= ddim_steps + 1``. Each needs the recon-free
        operating point, no ``cross_window_carry`` and a fresh run (no pack
        listed in the manifest); otherwise the loop runs.

        With a ``manifest``
        (:class:`~vface_torch.runtime.checkpoint.VideoProgressManifest`), a pack
        it lists as done is not recomputed: its frames are read back from the
        PNG paths it records. With a ``window_sink`` too, each computed pack
        goes to ``window_sink(start, frames (F, H, W, 3) float32 numpy) ->
        paths`` and then to ``manifest.mark_done``, in pack order on one
        worker thread, while the next pack runs; a sink that raises stops the
        marks there, and the error is raised. Every pack is marked before the
        call returns. With ``timings`` the device is synchronised at each
        stage boundary and each stage's wall seconds (align, parse, flow,
        conditionings, encode, invert, sample, decode, background,
        paste_back; pipelined: the fused sampling + next inversion evals;
        resumed: reading done windows back; with a sink, sink_wait: the wait
        for the last windows' sink after the loop) are added to it.
        """
        opts = self.opts
        if self.model.conditioner is None:
            raise ValueError("VideoSwapPipeline: the video path needs a model built with conditioner=True")
        n = int(frames01.shape[0])
        w = opts.window * max(1, opts.batch_windows)
        fresh = manifest is None or not any(manifest.is_done(s0) for s0 in range(0, n, w))
        exact = not opts.cross_window_carry and not opts.keep_recon_chunk
        can_superpack = opts.invert_packs == 2 and exact and opts.inversion_steps >= 2 and n >= 2 * w and fresh
        can_stream = (can_superpack and frame_landmarks is None and frame_keep is None
                      and isinstance(frames01, np.ndarray))
        can_pipeline = (opts.pipeline_packs and exact and opts.encoder_interval == 1
                        and opts.inversion_steps <= opts.ddim_steps + 1 and n >= w + 1 and fresh)
        remove_classes = remove_classes or TRAIN_REMOVE
        clock = StageClock(timings, self.device)
        src = self._source_inputs(source01, source_keep, remove_classes, clock)

        persist = _WindowPersist(manifest, window_sink) if manifest is not None and window_sink is not None else None
        out_frames = []

        def emit(s0, pasted, resumed=False):
            """A computed pack goes to the output (through the sink, with one); a resumed one is only kept."""
            pasted = pasted.float()
            out_frames.append(pasted.cpu() if persist is None or resumed else persist.submit(s0, pasted))

        try:
            if can_stream:
                self._swap_frames_superpacked_streaming(frames01, src, remove_classes, emit, clock, timings)
            else:
                frames01 = self._on(frames01)
                crops01, inv_coeffs = self.align_crops(frames01, landmarks=frame_landmarks)  # sets fallback_frames
                clock.mark("align")
                if frame_keep is not None:
                    keep_mask = self._coerce_keep(frame_keep, crops01.shape).to(self.device)
                else:
                    _, keep_mask = inpaint_inputs(crops01 * 2 - 1, self.parse_masks(crops01), remove_classes)
                clock.mark("parse")
                clip = (frames01, crops01, inv_coeffs, keep_mask)
                if can_superpack:
                    self._swap_frames_superpacked(*clip, src, emit, clock, timings)
                elif can_pipeline:
                    self._swap_frames_pipelined(*clip, src, emit, clock, timings)
                else:
                    self._swap_frames_sequential(*clip, src, emit, clock, timings, manifest, persist)
        finally:
            if persist is not None:
                persist.shutdown()
                clock.mark("sink_wait")  # the sink's work not hidden behind the windows
        if persist is not None:
            persist.raise_error()
        return torch.cat(out_frames, dim=0)

    def _swap_frames_sequential(self, frames01, crops01, inv_coeffs, keep_mask, src, emit, clock, timings,
                                manifest, persist) -> None:
        """The window loop, one pack at a time, with the cross-window carry:
        the carry is reset after a pack read back from the manifest, and no
        pair mask applies inside a pack while it is on."""
        opts = self.opts
        n = crops01.shape[0]
        w = opts.window * max(1, opts.batch_windows)
        carry = None
        for s0 in range(0, n, w):
            if persist is not None:
                persist.raise_error()
            if manifest is not None and manifest.is_done(s0):
                paths = manifest.data["windows"][str(s0)]["outputs"]
                emit(s0, torch.from_numpy(np.stack([_load_png01(p) for p in paths])), resumed=True)
                clock.mark("resumed")
                carry = None  # a window read back has no carry state
                continue
            sl = slice(s0, min(s0 + w, n))
            want_carry = opts.cross_window_carry and sl.stop - s0 > 1
            # the boundary flow: this window's frame 0 back to the previous window's last frame
            flow0 = self.compute_flow(crops01[s0 - 1:s0 + 1]) if want_carry and carry is not None else None
            p = self._pack_inputs(crops01[sl], keep_mask[sl], src, clock)
            res = self._swap_pack(frames01[sl], inv_coeffs[sl], p, src, timings,
                                  fgats_prev=carry if flow0 is not None else None, fgats_flow0=flow0,
                                  return_fgats=want_carry)
            pasted, carry = res if want_carry else (res, None)
            emit(s0, pasted)
            clock.reset()

    def _swap_frames_pipelined(self, frames01, crops01, inv_coeffs, keep_mask, src, emit, clock, timings) -> None:
        """The pipelined packs: a prologue inversion of pack 0, then per pack i
        one fused program (pack i's sampling with pack i+1's inversion), a
        sampling-only epilogue for the last full pack, and the trailing short
        window through :meth:`swap_window_pasted`."""
        opts = self.opts
        n = crops01.shape[0]
        w = opts.window * max(1, opts.batch_windows)
        n_full = n // w
        prep = lambda s0, stop: self._pack_inputs(crops01[s0:stop], keep_mask[s0:stop], src, clock)
        cur = prep(0, w)
        start, zi, ml = self._invert_pack(cur["c"], cur["km"], cur["inv_c"], timings=timings)
        clock.reset()  # the prologue's stages are on its own clock
        for i in range(n_full):
            sl = slice(i * w, (i + 1) * w)
            pack = (frames01[sl], inv_coeffs[sl], cur["km"], start, zi, ml, cur["cond"], cur["uncond"], cur["flow"],
                    cur["pm"])
            if i + 1 < n_full:
                nxt = prep(sl.stop, sl.stop + w)
                pasted, start, zi, ml = self._pipelined_step(*pack, nxt["c"], nxt["km"], nxt["inv_c"], timings=timings)
                cur = nxt
            else:
                pasted = self._final_pack(*pack, timings=timings)
            emit(sl.start, pasted)
            clock.reset()
        if n > n_full * w:
            s0 = n_full * w
            p = prep(s0, n)
            emit(s0, self._swap_pack(frames01[s0:], inv_coeffs[s0:], p, src, timings))

    def _swap_frames_superpacked(self, frames01, crops01, inv_coeffs, keep_mask, src, emit, clock, timings) -> None:
        """The super-pack loop: packs in pairs through :meth:`_superpack`, an
        odd trailing pack and the short remainder through
        :meth:`swap_window_pasted`. Each pack is emitted on its own."""
        w = self.opts.window * max(1, self.opts.batch_windows)
        n = crops01.shape[0]
        i = 0
        while (i + 2) * w <= n:
            sl = slice(i * w, (i + 2) * w)
            p = self._pack_inputs(crops01[sl], keep_mask[sl], src, clock, flow_fn=self.compute_flow_superpack)
            pasted = self._superpack(frames01[sl], inv_coeffs[sl], p["c"], p["km"], p["cond"], p["uncond"],
                                     p["inv_c"], p["flow"], timings=timings)
            emit(sl.start, pasted[:w])
            emit(sl.start + w, pasted[w:])
            clock.reset()
            i += 2
        for s0 in range(i * w, n, w):
            sl = slice(s0, min(s0 + w, n))
            p = self._pack_inputs(crops01[sl], keep_mask[sl], src, clock)
            emit(s0, self._swap_pack(frames01[sl], inv_coeffs[sl], p, src, timings))
            clock.reset()

    def _swap_frames_superpacked_streaming(self, frames01_np: np.ndarray, src, remove_classes, emit, clock,
                                           timings) -> None:
        """The super-pack loop on host frames, in groups of two packs: group
        i+1's whole preparation (the upload through pinned memory, landmarks
        and quads, the quad fetch and ``align_finish`` with the fallback quad
        carried across groups, parse, conditionings and flow) runs before
        super-pack i, so that its host work is done when the card takes the
        super-pack. The packs after the last group are aligned per pack and go
        through :meth:`swap_window_pasted`. The frames equal the super-pack
        loop's on the whole clip where the landmark net and the parser give
        the same results on a group as on the clip (on the card their
        convolutions round by batch)."""
        opts = self.opts
        n = int(frames01_np.shape[0])
        w = opts.window * max(1, opts.batch_windows)
        g = 2 * w
        n_groups = n // g

        def upload_and_begin(s0, stop):
            host = torch.from_numpy(np.ascontiguousarray(frames01_np[s0:stop], dtype=np.float32))
            if self.device.type == "cuda":
                host = host.pin_memory()
            fr = host.to(self.device, non_blocking=True)
            quad, qsize = self.align_begin(fr)
            return dict(s0=s0, fr=fr, quad=quad, qsize=qsize)

        def finish_prep(st, prev_quad, flow_fn=None):
            crops01, coeffs, prev_quad = self.align_finish(st["fr"], st["quad"], st["qsize"], prev_quad)
            clock.mark("align")
            _, keep = inpaint_inputs(crops01 * 2 - 1, self.parse_masks(crops01), remove_classes)
            clock.mark("parse")
            st.update(coeffs=coeffs, p=self._pack_inputs(crops01, keep, src, clock, flow_fn=flow_fn))
            return st, prev_quad

        superpack_prep = lambda st, prev_quad: finish_prep(st, prev_quad, self.compute_flow_superpack)
        cur, prev_quad = superpack_prep(upload_and_begin(0, g), None) if n_groups else (None, None)
        nxt_st = upload_and_begin(g, 2 * g) if n_groups > 1 else None
        for i in range(n_groups):
            nxt = None
            if nxt_st is not None:
                nxt, prev_quad = superpack_prep(nxt_st, prev_quad)
            p = cur["p"]
            pasted = self._superpack(cur["fr"], cur["coeffs"], p["c"], p["km"], p["cond"], p["uncond"], p["inv_c"],
                                     p["flow"], timings=timings)
            nxt_st = upload_and_begin((i + 2) * g, (i + 3) * g) if i + 2 < n_groups else None
            emit(cur["s0"], pasted[:w])
            emit(cur["s0"] + w, pasted[w:])
            clock.reset()
            cur = nxt
        for s0 in range(n_groups * g, n, w):
            st, prev_quad = finish_prep(upload_and_begin(s0, min(s0 + w, n)), prev_quad)
            emit(s0, self._swap_pack(st["fr"], st["coeffs"], st["p"], src, timings))
            clock.reset()


@torch.inference_mode()
def swap_video_frames_multiface(pipe: VideoSwapPipeline, frames01, source01, top_k: int = 2,
                                score_threshold: float = 0.3, remove_classes=None,
                                timings: Optional[dict] = None) -> torch.Tensor:
    """Swap up to ``top_k`` faces a frame with one source face: frames01 (N, H, W,
    3) in [0, 1] -> (N, H, W, 3) float32 in [0, 1], on the CPU.

    The face detector (``aux_params["detector"]``) gives ``top_k`` boxes a
    frame; faces whose mean score over the clip is under ``score_threshold``
    are skipped. The rest, in ascending mean score (the most confident is
    pasted last, on top), each run :meth:`VideoSwapPipeline.swap_video_frames`
    on the previous face's result, with that face's landmarks: the landmark
    net on the face's box crop (``image_size``^2), mapped back to frame
    pixels. ``timings`` collects the stages of every face's run and the
    detection's ("detect").
    """
    clock = StageClock(timings, pipe.device)
    frames = pipe._on(frames01)
    boxes, scores = pipe.detect_faces(frames, top_k)
    mean_scores = scores.mean(dim=0).cpu().numpy()
    clock.mark("detect")
    result = frames.cpu()
    s = pipe.opts.image_size
    for k in np.argsort(mean_scores):
        if mean_scores[k] < score_threshold:
            continue
        box = boxes[:, k]  # (N, 4) cx, cy, w, h
        lm_crop = pipe.detect_landmarks(crop_boxes(frames, box[:, None], s)[:, 0])  # (N, 68, 2) crop pixels
        origin = torch.stack([box[:, 0] - box[:, 2] / 2, box[:, 1] - box[:, 3] / 2], dim=-1)
        lm_frame = lm_crop * (box[:, 2:] / s)[:, None, :] + origin[:, None, :]
        clock.mark("detect")
        result = pipe.swap_video_frames(result, source01, remove_classes=remove_classes, frame_landmarks=lm_frame,
                                        timings=timings)
        clock.reset()
    return result


def pack_pair_mask(nf: int, window: int) -> Optional[np.ndarray]:
    """The FGATS blend mask (nf-1,) of a pack of consecutive windows of
    ``window`` frames: 0 at each pair that crosses a window boundary, 1
    elsewhere; None when the pack holds one window."""
    m = np.ones((nf - 1,), np.float32)
    for b0 in range(window, nf, window):
        m[b0 - 1] = 0.0
    return m if (m == 0).any() else None


def _load_png01(path: str) -> np.ndarray:
    """A PNG frame as float32 RGB (H, W, 3) in [0, 1]."""
    return read_png(path, mode="RGB").astype(np.float32) / 255.0


class _WindowPersist:
    """Hands computed windows to a sink and marks them done, in window order,
    on one worker thread. A window on the card is copied without blocking
    into pinned host memory; the worker waits for that copy, calls
    ``sink(start, frames)`` and ``manifest.mark_done``. After a sink error
    the later windows are neither sunk nor marked; :meth:`raise_error`
    raises it in the caller's thread."""

    def __init__(self, manifest, sink):
        self.manifest, self.sink = manifest, sink
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vface-window-sink")
        self.error: Optional[Exception] = None

    def submit(self, s0: int, pasted: torch.Tensor) -> torch.Tensor:
        """Queue one window; returns its frames on the CPU (valid once :meth:`shutdown` returns)."""
        ready = None
        host = pasted
        if pasted.device.type == "cuda":
            host = torch.empty(pasted.shape, dtype=pasted.dtype, pin_memory=True)
            host.copy_(pasted, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        self.pool.submit(self._persist, s0, host, ready)
        return host

    def _persist(self, s0: int, host: torch.Tensor, ready) -> None:
        if self.error is not None:
            return
        try:
            if ready is not None:
                ready.synchronize()
            frames = host.numpy()
            paths = self.sink(s0, frames)
            self.manifest.mark_done(s0, frames.shape[0], paths)
        except Exception as e:  # reported in the caller's thread by raise_error
            self.error = e

    def raise_error(self) -> None:
        if self.error is not None:
            raise self.error

    def shutdown(self) -> None:
        """Wait for every queued window."""
        self.pool.shutdown(wait=True)


class StageClock:
    """Wall seconds per stage, device-synchronised, added to a target dict; a
    no-op without one."""

    def __init__(self, target: Optional[dict], device: torch.device):
        self.target, self.device = target, device
        self.t = self._now() if target is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def reset(self) -> None:
        if self.target is not None:
            self.t = self._now()

    def mark(self, stage: str) -> None:
        if self.target is None:
            return
        now = self._now()
        self.target[stage] = self.target.get(stage, 0.0) + now - self.t
        self.t = now
