"""Batch video face swap: the port's ``scripts/vface_video_swap.py``.

Pairs target videos with source images from a YAML config (a list of
``{video, source[, masks][, audio]}`` mappings, as ``scripts/generate_config.py``
writes it), runs ``VideoSwapPipeline.swap_video_frames`` per video, and writes
the swapped video as AVI (with the source's audio when a ``.wav`` lies beside
the video, or the pair names one), Y4M and GIF, plus one PNG per frame under
``<outdir>/<name>_frames/``. Idempotent: a video whose ``.avi`` exists is
skipped, and within a video the windows its progress manifest
(``<name>.manifest.json``) lists are read back instead of recomputed.

Inputs are Y4M videos or directories of ``{i}.png`` frames. A pair's
``masks:`` directory of ``{i}.png`` parse maps (CelebAMask-HQ classes)
replaces the frames' BiSeNet parse.

    VFACE_PLATFORM=cpu python -m vface_torch.scripts.vface_video_swap --tiny --config pairs.yaml
    python -m vface_torch.scripts.vface_video_swap --config pairs.yaml --outdir results/video_swap

Runs on CUDA, and raises without a card, unless ``VFACE_PLATFORM=cpu``. The
flags are the JAX CLI's; ``--mesh_data`` / ``--mesh_frames`` other than 0
(multi-GPU, ROADMAP A13) raise ``NotImplementedError``. Without ``--params`` /
``--aux_params`` the weights are the port's seeded init (``--seed``), which is
not the JAX package's; the npz files the JAX package's ``save_params_npz``
writes load as they are.
Each video prints ``[done]`` (frames, the swap's seconds and frames/s, the
sink's seconds), ``[skip]`` or ``[fail]``; the exit code is 1 if any failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PNG_THREADS = 4  # a window's frames encoded at once; the rest of the host's cores feed the card


def load_frames(path: str):
    """A Y4M file or a directory of ``{i}.png`` frames -> (float32 (N, H, W, 3) in [0, 1], fps)."""
    from vface_torch.io.image import read_png
    from vface_torch.io.video import read_y4m

    if path.endswith(".y4m"):
        frames, fps = read_y4m(path)
        return frames.astype(np.float32) / 255.0, fps
    files = sorted((f for f in os.listdir(path) if f.endswith(".png")), key=lambda f: int(os.path.splitext(f)[0]))
    frames = np.stack([read_png(os.path.join(path, f), mode="RGB").astype(np.float32) / 255.0 for f in files])
    return frames, 10


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="YAML: [{video:..., source:...}]")
    ap.add_argument("--outdir", default="results/video_swap")
    ap.add_argument("--params", default=None, help="npz params snapshot (else the port's seeded init)")
    ap.add_argument("--aux_params", default=None, help="npz aux nets snapshot")
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--inversion_steps", type=int, default=50,
                    help="fixed 50 in the reference regardless of --ddim_steps")
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--n_frames", type=int, default=6, help="window size")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    ap.add_argument("--mesh_data", type=int, default=0,
                    help="shard full windows over N devices (not ported: ROADMAP A13)")
    ap.add_argument("--mesh_frames", type=int, default=0,
                    help="shard each window's frames over N devices (not ported: ROADMAP A13)")
    ap.add_argument("--batch_windows", type=int, default=1,
                    help="pack N consecutive windows into one call (equal to separate windows through "
                         "boundary-masked FGATS; larger UNet batches)")
    ap.add_argument("--cross_window_carry", action="store_true",
                    help="experimental: FGATS carry across window boundaries (beyond the reference; the "
                         "sequential loop only; its benefit needs trained weights to show)")
    args = ap.parse_args(argv)
    if args.mesh_data and args.mesh_frames:
        ap.error("--mesh_data and --mesh_frames are mutually exclusive")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh_data or args.mesh_frames:
        raise NotImplementedError("--mesh_data / --mesh_frames (multi-GPU windows and frames) are ROADMAP A13")

    import torch

    from vface_torch.data.datasets import _load_mask
    from vface_torch.io.image import read_png, write_png
    from vface_torch.io.video import read_wav, write_avi, write_gif, write_y4m
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.preprocess.masks import TRAIN_REMOVE, region_mask
    from vface_torch.runtime.checkpoint import VideoProgressManifest, load_params_npz
    from vface_torch.utils.config import load_yaml
    from vface_torch.utils.convert import init_aux_params, init_params
    from vface_torch.utils.platform import device_from_env

    device = device_from_env()
    cfg = ModelConfig.tiny(image_size=32) if args.tiny else ModelConfig.sd_v1_inpaint()
    model = VFaceModel(cfg, device=device, conditioner=True)
    if args.params:
        model.load_params(load_params_npz(args.params))
    else:
        model.load_params(init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), conditioner=True))
    if args.aux_params:
        aux = load_params_npz(args.aux_params)
    else:  # the landmark net from the shipped weights, the others seeded
        aux = init_aux_params(torch.Generator(device=device).manual_seed(args.seed + 1))

    opts = SwapOptions(ddim_steps=args.ddim_steps, inversion_steps=args.inversion_steps, cfg_scale=args.scale,
                       window=args.n_frames, image_size=cfg.image_size, parser_size=64 if args.tiny else 512,
                       cross_window_carry=args.cross_window_carry, batch_windows=args.batch_windows)
    pipe = VideoSwapPipeline(model, opts, device=device, aux_params=aux)

    pairs = load_yaml(args.config)
    os.makedirs(args.outdir, exist_ok=True)
    failed = 0
    for pair in pairs:
        name = os.path.splitext(os.path.basename(pair["video"]))[0]
        out_base = os.path.join(args.outdir, name)
        if os.path.exists(out_base + ".avi"):
            print(f"[skip] {name}: output exists", flush=True)
            continue
        manifest = VideoProgressManifest(out_base + ".manifest.json", meta={
            "window": opts.window, "ddim_steps": opts.ddim_steps, "inversion_steps": opts.inversion_steps,
            "cfg_scale": opts.cfg_scale, "image_size": opts.image_size, "seed": args.seed})
        frame_dir = out_base + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        sink_s = [0.0]

        def window_sink(s0, pasted01, frame_dir=frame_dir, sink_s=sink_s):
            # durable per-window outputs: a preempted run resumes by skipping completed windows;
            # the frames' PNGs are encoded in parallel (zlib releases the GIL)
            t0 = time.perf_counter()

            def write(j):
                p = os.path.join(frame_dir, f"{s0 + j}.png")
                write_png(p, (np.clip(pasted01[j], 0, 1) * 255).astype(np.uint8))
                return p

            with ThreadPoolExecutor(max_workers=PNG_THREADS) as pool:
                paths = list(pool.map(write, range(len(pasted01))))
            sink_s[0] += time.perf_counter() - t0
            return paths

        try:
            frames01, _ = load_frames(pair["video"])
            source01 = read_png(pair["source"], mode="RGB").astype(np.float32) / 255.0
            frame_keep = None
            if pair.get("masks"):  # precomputed parse maps replace the frames' BiSeNet parse
                m = np.stack([_load_mask(os.path.join(pair["masks"], f"{i}.png"), opts.image_size)
                              for i in range(len(frames01))])
                face = region_mask(torch.from_numpy(m), TRAIN_REMOVE).numpy()
                frame_keep = (1.0 - face)[..., None].astype(np.float32)
            t0 = time.perf_counter()
            swapped = pipe.swap_video_frames(frames01, source01, manifest=manifest, window_sink=window_sink,
                                             frame_keep=frame_keep)
            swap_s = time.perf_counter() - t0
            u8 = (np.clip(swapped.numpy(), 0, 1) * 255).astype(np.uint8)
            # audio passthrough: a `.wav` beside the video, or the pair's `audio:`, goes into the AVI
            audio = sr = None
            wav = pair.get("audio") or os.path.splitext(pair["video"])[0] + ".wav"
            if os.path.exists(wav):
                audio, sr = read_wav(wav)
            write_avi(out_base + ".avi", u8, fps=args.fps, audio=audio, sample_rate=sr or 0)
            write_y4m(out_base + ".y4m", u8, fps=args.fps)
            write_gif(out_base + ".gif", u8, fps=args.fps)
            print(f"[done] {name}: {len(u8)} frames, swap {swap_s:.3f} s ({len(u8) / swap_s:.4f} frames/s), "
                  f"sink {sink_s[0]:.3f} s", flush=True)
        except Exception as e:  # one video's failure skips it, as the reference does
            failed += 1
            print(f"[fail] {name}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
