"""The REFace image face swap and the image test bench.

Port of ``vface_tpu/pipelines/image_swap.py``:

* :class:`ImageSwapOptions`, the operating point (50 steps, scale 3.0, 512^2);
* :func:`swap_image_batch`, the device core: conditioning (CLIP of the
  source and of the target, ArcFace of the source, the target's landmarks),
  the VAE encode of the inpaint image, CFG DDIM from seeded noise, decode;
* :func:`run_test_bench`, which streams the test bench's fixed pairs
  (:func:`vface_torch.data.datasets.test_bench_pairs`, with their parse maps)
  through it in batches.

The noise: the JAX core draws x_T from ``PRNGKey(42)`` afresh on every call,
so every batch of the test bench starts from the same x_T. Torch cannot
replay threefry; the port draws x_T from a noise source, ``noise(0, shape)``,
by default a ``torch.Generator`` seeded with 42 afresh on every call
(:func:`vface_torch.samplers.ddim.seeded_noise`), which keeps that property;
a caller that needs JAX's x_T passes a source that gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from vface_torch.models.clip import clip_preprocess
from vface_torch.ops.warp import resize_bilinear
from vface_torch.pipelines.video_swap import StageClock
from vface_torch.preprocess.landmarks import LandmarkNet, landmarks_to_vector
from vface_torch.preprocess.masks import TRAIN_REMOVE, inpaint_inputs
from vface_torch.samplers.ddim import NoiseFn, ddim_sample, seeded_noise

NOISE_SEED = 42  # the JAX core's PRNGKey(42)


@dataclasses.dataclass(frozen=True)
class ImageSwapOptions:
    ddim_steps: int = 50
    cfg_scale: float = 3.0  # the test bench's; the selected-pairs CLI uses 3.5
    image_size: int = 512


def _on(x, device) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


@torch.inference_mode()
def swap_image_batch(model, target, keep_mask, src_clip, src_face01, landmarks136=None,
                     opts: ImageSwapOptions = ImageSwapOptions(), noise: Optional[NoiseFn] = None,
                     timings: Optional[dict] = None) -> torch.Tensor:
    """Swapped crops (B, S, S, 3) float32 in [0, 1] on the model's device.

    target (B, S, S, 3) aligned target crops in [-1, 1]; keep_mask (B, S, S,
    1), 1 = background kept; src_clip (B, 224, 224, 3) the CLIP-normalised
    source faces; src_face01 (B, h, w, 3) the [0, 1] source for ArcFace;
    landmarks136 (B, 136) the target's. The model needs its conditioner.
    ``noise(0, (B, h, w, 4))`` gives x_T (default: :data:`NOISE_SEED`, afresh
    per call). With ``timings`` (a dict) the device is synchronised at each
    stage boundary and the seconds of conditioning, encode, sample and decode
    are added to it.
    """
    dev = model.device
    target, keep_mask, src_clip, src_face01 = (_on(a, dev) for a in (target, keep_mask, src_clip, src_face01))
    landmarks136 = None if landmarks136 is None else _on(landmarks136, dev)
    b, hl = target.shape[0], model.cfg.latent_size
    clock = StageClock(timings, dev)

    tar_clip = clip_preprocess((target + 1.0) * 0.5, model.cfg.cond.clip.image_size)
    cond = model.conditioning(src_clip, landmarks136, tar_clip, src_face01)
    uncond = model.uncond(b)
    clock.mark("conditioning")
    z_inpaint = model.encode_first_stage(target * keep_mask)
    mask_lat = resize_bilinear(keep_mask, hl, hl)
    clock.mark("encode")
    x_T = (noise or seeded_noise(dev, NOISE_SEED))(0, (b, hl, hl, 4)).to(device=dev, dtype=torch.float32)
    z0, _ = ddim_sample(model, x_T, cond, uncond, z_inpaint, mask_lat, num_steps=opts.ddim_steps,
                        cfg_scale=opts.cfg_scale)
    clock.mark("sample")
    out = torch.clamp((model.decode_first_stage(z0).to(torch.float32) + 1.0) * 0.5, 0.0, 1.0)
    clock.mark("decode")
    return out


def run_test_bench(model, aux_params: dict, pairs: Iterable[dict], opts: ImageSwapOptions = ImageSwapOptions(),
                   batch_size: int = 4, noise: Optional[NoiseFn] = None) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream test-bench pairs (``{"name", "source", "target", "mask"}``, images in
    [-1, 1], the target's parse map) through :func:`swap_image_batch` in batches
    of ``batch_size``; yields (name, swapped (S, S, 3) float32 in [0, 1]) per
    pair. ``aux_params["landmark"]`` is the landmark net's state dict."""
    dev = model.device
    with torch.device(dev):
        lm_net = LandmarkNet().eval()
    lm_net.load_state_dict(aux_params["landmark"])
    size = model.cfg.cond.clip.image_size
    buf = []

    def flush():
        with torch.inference_mode():
            if any("mask" not in item for item in buf):
                raise ValueError("run_test_bench needs each pair's parse map (test_bench_pairs' mask_dir)")
            tar = torch.stack([_on(item["target"], dev) for item in buf])
            mask = torch.stack([torch.as_tensor(np.asarray(item["mask"]), device=dev) for item in buf])
            _, keep = inpaint_inputs(tar, mask, TRAIN_REMOVE)
            src01 = torch.stack([(_on(item["source"], dev) + 1.0) * 0.5 for item in buf])
            lms = landmarks_to_vector(lm_net((tar + 1.0) * 0.5))
            out = swap_image_batch(model, tar, keep, clip_preprocess(src01, size), src01, lms, opts, noise=noise)
        return [(item["name"], o) for item, o in zip(buf, out.cpu().numpy())]

    for item in pairs:
        buf.append(item)
        if len(buf) == batch_size:
            yield from flush()
            buf = []
    if buf:
        yield from flush()
