"""One source onto one target image, or every source onto every target: the
port's ``scripts/one_inference.py``.

Aligns both faces, parses them into keep-masks, swaps the aligned target
crop with the plain 2-chunk CFG DDIM (:func:`vface_torch.pipelines.image_swap.swap_image_batch`),
and pastes the crop back into the target through the inverse perspective
transform, over the VAE round trip of the whole target (the background
trick). Given folders, every source goes onto every target and the results
are ``<out>/<source>_to_<target>.png``.

    VFACE_PLATFORM=cpu python -m vface_torch.scripts.one_inference --tiny --target t.png --source s.png --out o.png
    python -m vface_torch.scripts.one_inference --target targets/ --source sources/ --out results/ --watermark

``--watermark`` embeds the invisible watermark (:mod:`vface_torch.utils.watermark`)
in every output; ``--safety_params`` (an npz of the safety checker's tree,
the CLIP tower under flat ``clip/<path>`` keys) blacks out flagged outputs.
Runs on CUDA, and raises without a card, unless ``VFACE_PLATFORM=cpu``. The
flags are the JAX CLI's; without ``--params`` the weights are the port's
seeded init (``--seed``); the aux nets are seeded (``--seed`` + 1; the
landmark net from its shipped weights), as the JAX CLI's are seeded too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


def swap_one(pipe, target01, source01, opts, noise=None) -> np.ndarray:
    """One target (H, W, 3) and one source image in [0, 1] -> the full-frame
    result (H, W, 3) float32 in [0, 1]. ``noise`` is
    :func:`~vface_torch.pipelines.image_swap.swap_image_batch`'s x_T source."""
    import torch

    from vface_torch.models.clip import clip_preprocess
    from vface_torch.pipelines.image_swap import swap_image_batch
    from vface_torch.preprocess.align import paste_back
    from vface_torch.preprocess.landmarks import landmarks_to_vector
    from vface_torch.preprocess.masks import TRAIN_REMOVE, inpaint_inputs

    model = pipe.model
    with torch.inference_mode():
        tar, src = pipe._on(target01)[None], pipe._on(source01)[None]
        tar_crop, inv_coeffs = pipe.align_crops(tar)
        src_crop, _ = pipe.align_crops(src)
        _, keep = inpaint_inputs(tar_crop * 2 - 1, pipe.parse_masks(tar_crop), TRAIN_REMOVE)
        _, src_keep = inpaint_inputs(src_crop * 2 - 1, pipe.parse_masks(src_crop), TRAIN_REMOVE)
        src_clip = clip_preprocess(src_crop * (1 - src_keep), model.cfg.cond.clip.image_size)
        lms = landmarks_to_vector(pipe.detect_landmarks(tar_crop))
        swapped = swap_image_batch(model, tar_crop * 2 - 1, keep, src_clip, src_crop, lms, opts, noise=noise)
        bg = pipe.decode_with_background(tar * 2 - 1)
        return paste_back(bg, swapped, inv_coeffs, 1.0 - keep)[0].float().cpu().numpy()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--target", required=True, help="target image OR folder")
    ap.add_argument("--source", required=True, help="source image OR folder")
    ap.add_argument("--out", default="swapped.png", help="output image OR folder")
    ap.add_argument("--params", default=None, help="npz params snapshot (else the port's seeded init)")
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=3.5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    ap.add_argument("--watermark", action="store_true", help="embed the invisible watermark in the outputs")
    ap.add_argument("--safety_params", default=None,
                    help="npz of the safety checker's params; flagged outputs are blacked out")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from vface_torch.io.image import write_png
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.image_swap import ImageSwapOptions
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.runtime.checkpoint import load_params_npz
    from vface_torch.utils.convert import from_flax_safety, init_aux_params, init_params
    from vface_torch.utils.platform import device_from_env
    from vface_torch.utils.watermark import SafetyChecker, embed_watermark

    device = device_from_env()
    cfg = ModelConfig.tiny(image_size=32) if args.tiny else ModelConfig.sd_v1_inpaint()
    model = VFaceModel(cfg, device=device, conditioner=True)
    if args.params:
        model.load_params(load_params_npz(args.params))
    else:
        model.load_params(init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), conditioner=True))
    aux = init_aux_params(torch.Generator(device=device).manual_seed(args.seed + 1))
    pipe = VideoSwapPipeline(model, SwapOptions(image_size=cfg.image_size, parser_size=64 if args.tiny else 512),
                             device=device, aux_params={k: aux[k] for k in ("bisenet", "landmark")})
    opts = ImageSwapOptions(args.ddim_steps, args.scale, cfg.image_size)

    safety = None
    if args.safety_params:
        with np.load(args.safety_params) as npz:
            safety = (SafetyChecker(cfg.cond.clip, device=device), from_flax_safety(dict(npz)))

    def finalize(out01: np.ndarray) -> np.ndarray:
        if safety is not None:
            checker, sp = safety
            checked, flagged = checker.check(sp, out01[None])
            if flagged[0]:
                print("[safety] potential unsafe content — output blacked out", flush=True)
            out01 = checked[0]
        u8 = (np.clip(out01, 0, 1) * 255).astype(np.uint8)
        return embed_watermark(u8) if args.watermark else u8

    if os.path.isdir(args.target):  # every source onto every target
        os.makedirs(args.out, exist_ok=True)
        for t in sorted(os.listdir(args.target)):
            for s in sorted(os.listdir(args.source)):
                out01 = swap_one(pipe, _load(os.path.join(args.target, t)), _load(os.path.join(args.source, s)),
                                 opts)
                name = f"{os.path.splitext(s)[0]}_to_{os.path.splitext(t)[0]}.png"
                write_png(os.path.join(args.out, name), finalize(out01))
                print(f"[done] {name}", flush=True)
    else:
        write_png(args.out, finalize(swap_one(pipe, _load(args.target), _load(args.source), opts)))
        print(f"[done] {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
