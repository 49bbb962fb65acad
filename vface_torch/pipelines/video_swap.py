"""The VFace video face swap: align, parse, flow, conditionings, windows, paste-back.

Port of ``vface_tpu/pipelines/video_swap.py``'s sequential path:

* :class:`SwapOptions`, the operating point (the fields the sequential path
  reads; the pipelined and super-pack schedulers' fields are kept so that
  asking for them raises instead of running something else);
* :class:`VideoSwapPipeline`, the diffusion model with the aux nets (BiSeNet,
  RAFT, LandmarkNet) on one device, and its stages: ``detect_landmarks``,
  ``align_begin`` / ``align_finish`` (the host fallback for degenerate quads)
  / ``align_crops``, ``parse_masks``, ``compute_flow``,
  ``window_conditionings``, ``swap_window`` (the window core:
  ``_swap_window_impl``'s semantics), ``swap_window_pasted`` with
  ``decode_with_background``, and ``swap_video_frames``, the window loop.

The window core: VAE encode of the target crops and of the masked inpaint
image; DDIM inversion (``skip_last=1`` in the recon-free mode: only the t=961
start code is consumed); hooked CFG sampling (FSAI + FGATS at the input-block
attn1 sites), 2-chunk unless ``keep_recon_chunk``; VAE decode and a clip to
[0, 1]. The source is only encoded when ``co_invert_source`` asks for the
literal co-inverted batch.

The window loop packs ``batch_windows`` consecutive windows into one call
(the FGATS blend masked at each window boundary, so the frames equal
separate windows'), and with a ``manifest`` and a ``window_sink`` it is
resumable: windows the manifest lists are read back from the sink's PNGs,
and each computed window is handed to the sink and marked done in window
order on a worker thread while the next window runs.

Not ported yet, and raising ``NotImplementedError`` where the JAX package
would take them (ROADMAP A4, A7, A9): the cross-window FGATS carry, the
super-pack, streaming and pipelined schedulers, ``eta > 0`` and
``encoder_interval > 1``. Where the JAX package's eligibility test for a
scheduler fails, it runs the sequential loop, and so does the port.
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
from vface_torch.preprocess.landmarks import LandmarkNet, landmarks_to_vector
from vface_torch.preprocess.masks import TRAIN_REMOVE, inpaint_inputs
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import vface_sample
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
    eta: float = 0.0  # 0 only (a seeded noise source for eta > 0 is ROADMAP A7)
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    # literal reference inversion batch cat([target, source]); the source
    # half is never consumed, so it is off by default
    co_invert_source: bool = False
    # literal 3-chunk sampling batch; the recon chunk is inert, so off by default
    keep_recon_chunk: bool = False
    encoder_interval: int = 1  # 1 only (encoder propagation is ROADMAP A7)
    cross_window_carry: bool = False  # not ported (ROADMAP A4/A7): asking for it raises
    # pack this many consecutive windows into one call, the FGATS blend masked
    # at the window boundaries (the frames equal separate windows')
    batch_windows: int = 1
    # token count at which FGATS applies (4096 = the 64x64 grid at 512px)
    flow_tokens: int = 4096
    # the pipelined-pack and super-pack schedulers are not ported (ROADMAP A9):
    # where the JAX package would take one, the port raises
    pipeline_packs: bool = False
    invert_packs: int = 1
    raft_iters: int = 20  # RAFT GRU iterations (the reference pins 20)
    # background-trick resolution: 0 = full resolution (exact); r > 0 runs
    # the VAE round trip at r^2 and upsamples (only background pixels change)
    background_res: int = 0


_AUX = {"bisenet": "bisenet", "raft": "raft", "landmark": "landmark_net"}
# At 6 or more pairs of 512^2 crops, cuDNN's heuristics give RAFT's update
# block (64^2 maps) an FFT-tiled convolution launched tile by tile: 432.7 and
# 343.6 ms a pair at 6 and 11 pairs against 45.1 at 5 (an H100 80GB HBM3;
# chip_smoke.py's cli_flow_batch line, PERF.md §6)
RAFT_MAX_PAIRS = 5


class VideoSwapPipeline:
    """The diffusion model plus the aux nets and the window ops, on one device
    (CUDA unless asked otherwise). The aux nets' parameters come from
    ``aux_params`` (``{"bisenet", "raft", "landmark"}`` state dicts, any
    subset, each loaded strictly; e.g. from
    :func:`vface_torch.utils.convert.from_flax_aux` or ``init_aux_params``); a
    stage whose net has none raises. ``swap_window`` needs neither; the video
    path needs them and a model built with ``conditioner=True``."""

    def __init__(self, model: VFaceModel, opts: SwapOptions = SwapOptions(), device="cuda",
                 aux_params: Optional[dict] = None):
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
        with torch.device(self.device):
            self.bisenet = BiSeNet().eval()
            self.raft = RAFT(RAFTConfig(iters=opts.raft_iters)).eval()
            self.landmark_net = LandmarkNet().eval()
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
    @torch.inference_mode()
    def swap_window(self, crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop,
                    src_keep_mask, flow: Optional[torch.Tensor] = None,
                    timings: Optional[dict] = None, pair_mask=None) -> torch.Tensor:
        """One window (or a pack of windows) -> swapped crops (F, S, S, 3) in [0, 1].

        crops (F, S, S, 3) in [-1, 1]; keep_mask (F, S, S, 1), 1 = background
        kept; cond / uncond / inverse_cond / cond_w_src (F, 1, D); src_crop
        (1, S, S, 3) in [-1, 1]; src_keep_mask (1, S, S, 1); flow (F-1, S, S, 2)
        in pixels or None; pair_mask (F-1,) or None, with a flow: 0 turns off
        the FGATS blend of pair (i, i+1) (a window boundary inside a pack). With
        ``timings`` (a dict) the device is synchronised
        at each stage boundary and the wall seconds of encode, invert, sample
        and decode are added to it.
        """
        opts, model = self.opts, self.model
        if opts.eta != 0.0:
            raise NotImplementedError("eta > 0 needs the sampler's seeded noise source (ROADMAP A7)")
        if opts.encoder_interval != 1:
            raise NotImplementedError("encoder_interval > 1 (encoder propagation) is ROADMAP A7")
        dev = self.device
        args = [crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask, flow, pair_mask]
        (crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop, src_keep_mask,
         flow, pair_mask) = [None if a is None else self._on(a) for a in args]
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
                             cfg_scale=opts.cfg_scale, drop_recon_chunk=not opts.keep_recon_chunk,
                             flow_pair_mask=pair_mask)
        clock.mark("sample")

        out = model.decode_first_stage(z0)
        out01 = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
        clock.mark("decode")
        return out01

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

    @torch.inference_mode()
    def swap_window_pasted(self, frames01_w, inv_coeffs_w, crops, keep_mask, cond, uncond, inverse_cond,
                           cond_w_src, src_crop, src_keep_mask, flow=None,
                           timings: Optional[dict] = None, pair_mask=None) -> torch.Tensor:
        """:meth:`swap_window`, the background trick on the window's original
        frames (F, H, W, 3) in [0, 1], and the paste-back of the swapped crops
        through ``inv_coeffs_w`` (F, 8) with the face region (1 - keep_mask) as
        the mask -> (F, H, W, 3) in [0, 1]; ``timings`` adds "background" and
        "paste_back" to the window's stages."""
        keep_mask = self._on(keep_mask)
        swapped = self.swap_window(crops, keep_mask, cond, uncond, inverse_cond, cond_w_src, src_crop,
                                   src_keep_mask, flow, timings=timings, pair_mask=pair_mask)
        clock = _StageClock(timings, self.device)
        bg = self.decode_with_background(self._on(frames01_w) * 2.0 - 1.0)
        clock.mark("background")
        pasted = paste_back(bg, swapped, self._on(inv_coeffs_w), 1.0 - keep_mask)
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

    def _refuse_unported_paths(self, n: int, manifest) -> None:
        """Raise where the JAX package would leave the sequential loop: its
        eligibility tests for the super-pack (and streaming) and pipelined
        schedulers, on the packed window ``window * batch_windows``."""
        opts = self.opts
        if opts.cross_window_carry:
            raise NotImplementedError("cross_window_carry (the FGATS carry across windows) is ROADMAP A4/A7")
        w = opts.window * max(1, opts.batch_windows)
        exact = not opts.keep_recon_chunk
        fresh = manifest is None or not any(manifest.is_done(s0) for s0 in range(0, n, w))
        if opts.invert_packs == 2 and exact and opts.inversion_steps >= 2 and n >= 2 * w and fresh:
            raise NotImplementedError("the super-pack and streaming schedulers (invert_packs=2) are ROADMAP A9")
        if (opts.pipeline_packs and exact and opts.encoder_interval == 1
                and opts.inversion_steps <= opts.ddim_steps + 1 and n >= w + 1 and fresh):
            raise NotImplementedError("the pipelined-pack scheduler (pipeline_packs) is ROADMAP A9")

    # ------------------------------------------------------------ full run
    @torch.inference_mode()
    def swap_video_frames(self, frames01, source01, remove_classes=None, manifest=None, window_sink=None,
                          frame_landmarks=None, frame_keep=None, source_keep=None,
                          timings: Optional[dict] = None) -> torch.Tensor:
        """Align, parse, then the window loop (flow, conditionings, window,
        background, paste-back): frames01 (N, H, W, 3) in [0, 1] and
        source01 (H', W', 3) -> swapped frames (N, H, W, 3) float32 in [0, 1], on the CPU.

        ``frame_keep`` / ``source_keep``: precomputed keep masks (1 = background
        kept) in crop space, (N, S, S[, 1]) / (S, S[, 1]); the parse of that
        side is then skipped. ``frame_landmarks`` (N, 68, 2) replaces the
        frames' landmark detection.

        The loop steps over packs of ``window * batch_windows`` frames. With a
        ``manifest`` (:class:`~vface_torch.runtime.checkpoint.VideoProgressManifest`),
        a pack it lists as done is not recomputed: its frames are read back
        from the PNG paths it records. With a ``window_sink`` too, each
        computed pack goes to ``window_sink(start, frames (F, H, W, 3) float32
        numpy) -> paths`` and then to ``manifest.mark_done``, in pack order on
        one worker thread, while the next pack runs; a sink that raises stops
        the marks there, and the error is raised. Every pack is marked before
        the call returns. With ``timings`` the device is
        synchronised at each stage boundary and each stage's wall seconds
        (align, parse, flow, conditionings, encode, invert, sample, decode,
        background, paste_back; resumed: reading done windows back; with a
        sink, sink_wait: the wait for the last windows' sink after the loop)
        are added to it.
        """
        opts = self.opts
        n = int(frames01.shape[0])
        self._refuse_unported_paths(n, manifest)
        if self.model.conditioner is None:
            raise ValueError("VideoSwapPipeline: the video path needs a model built with conditioner=True")
        remove_classes = remove_classes or TRAIN_REMOVE
        clip_size = self.model.cfg.cond.clip.image_size
        clock = _StageClock(timings, self.device)
        frames01 = self._on(frames01)
        src = self._on(source01)[None]

        src_crop01, _ = self.align_crops(src)
        crops01, inv_coeffs = self.align_crops(frames01, landmarks=frame_landmarks)  # sets fallback_frames
        clock.mark("align")
        if frame_keep is not None:
            keep_mask = self._coerce_keep(frame_keep, crops01.shape).to(self.device)
        else:
            _, keep_mask = inpaint_inputs(crops01 * 2 - 1, self.parse_masks(crops01), remove_classes)
        if source_keep is not None:
            src_keep = self._coerce_keep(source_keep[None], src_crop01.shape).to(self.device)
        else:
            _, src_keep = inpaint_inputs(src_crop01 * 2 - 1, self.parse_masks(src_crop01), remove_classes)
        clock.mark("parse")
        # the masked, CLIP-normalised source reference and the source's landmarks
        src_clip = clip_preprocess(src_crop01 * (1.0 - src_keep), clip_size)
        src_lm = landmarks_to_vector(self.detect_landmarks(src_crop01))
        clock.mark("conditionings")

        w = opts.window * max(1, opts.batch_windows)
        persist = _WindowPersist(manifest, window_sink) if manifest is not None and window_sink is not None else None
        out_frames = []
        try:
            for s0 in range(0, n, w):
                if persist is not None:
                    persist.raise_error()
                if manifest is not None and manifest.is_done(s0):
                    paths = manifest.data["windows"][str(s0)]["outputs"]
                    out_frames.append(torch.from_numpy(np.stack([_load_png01(p) for p in paths])))
                    clock.mark("resumed")
                    continue
                sl = slice(s0, min(s0 + w, n))
                c, km = crops01[sl] * 2 - 1, keep_mask[sl]
                nf = sl.stop - s0
                flow = self.compute_flow(crops01[sl]) if nf > 1 else None
                clock.mark("flow")
                pair_mask = pack_pair_mask(nf, opts.window) if flow is not None and opts.batch_windows > 1 else None
                cond, uncond, inv_c, c_src = self.window_conditionings(c, km, src_clip, src_crop01, src_lm)
                clock.mark("conditionings")
                pasted = self.swap_window_pasted(frames01[sl], inv_coeffs[sl], c, km, cond, uncond, inv_c, c_src,
                                                 src_crop01 * 2 - 1, src_keep, flow, timings=timings,
                                                 pair_mask=pair_mask)
                pasted = pasted.float()
                out_frames.append(pasted.cpu() if persist is None else persist.submit(s0, pasted))
                clock.reset()
        finally:
            if persist is not None:
                persist.shutdown()
                clock.mark("sink_wait")  # the sink's work not hidden behind the windows
        if persist is not None:
            persist.raise_error()
        return torch.cat(out_frames, dim=0)


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


class _StageClock:
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
