"""Driven comparison videos with the face-vid2vid generator: the port's ``scripts/driven_demo.py``.

Animates a (swapped) source portrait with the motion of a driving video, one
driving frame at a time, and writes the frames as an AVI (REFace's
``eval_tool/face_vid2vid/driven_demo_video.py``, the side-by-side videos of the
qualitative eval).

    VFACE_PLATFORM=cpu python -m vface_torch.scripts.driven_demo --tiny --source s.png --driving d.y4m --out o.avi
    python -m vface_torch.scripts.driven_demo --source s.png --driving frames/ --params fv2v.npz --out o.avi

``--driving`` is a .y4m file or a folder of PNG frames (sorted by name);
``--params`` is an npz of the generator's tree under its Flax paths (the JAX
package's ``save_params_npz`` layout; :func:`vface_torch.runtime.checkpoint.save_params_npz`
writes one). The flags are the JAX script's. Without ``--params`` the
weights are the port's seeded init (a CPU generator seeded with 0, the same
on every device), where JAX's script inits from ``PRNGKey(0)``. Runs on
CUDA, and raises without a card, unless ``VFACE_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True, help="portrait image")
    ap.add_argument("--driving", required=True, help="driving video (.y4m or frame dir)")
    ap.add_argument("--out", default="driven.avi")
    ap.add_argument("--params", default=None, help="npz generator weights")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--tiny", action="store_true")
    return ap.parse_args(argv)


def read_driving(path: str) -> np.ndarray:
    """A .y4m file or a folder of PNG frames -> (F, H, W, 3) float32 in [0, 1]."""
    from vface_torch.io.image import read_png
    from vface_torch.io.video import read_y4m

    if path.endswith(".y4m"):
        frames, _ = read_y4m(path)
        return frames.astype(np.float32) / 255.0
    files = sorted(f for f in os.listdir(path) if f.endswith(".png"))
    return np.stack([read_png(os.path.join(path, f), "RGB") for f in files]).astype(np.float32) / 255.0


def load_generator(cfg, params: str = None, device="cuda"):
    """:class:`OcclusionAwareGenerator` on ``device`` in eval mode: its weights
    from an npz of the Flax tree, else seeded (:func:`init_params` with a CPU
    generator seeded with 0: the same weights on every device)."""
    import torch

    from vface_torch.models.face_vid2vid import OcclusionAwareGenerator, init_params
    from vface_torch.runtime.checkpoint import read_flat_npz
    from vface_torch.utils.convert import flax_tree_to_state_dict

    gen = OcclusionAwareGenerator(cfg)
    if params:
        gen.load_state_dict(flax_tree_to_state_dict(read_flat_npz(params)))
    else:
        init_params(gen, torch.Generator().manual_seed(0))
    return gen.to(device).eval()


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from PIL import Image

    from vface_torch.io.video import write_avi
    from vface_torch.models.face_vid2vid import FV2VConfig
    from vface_torch.ops.warp import resize_bilinear
    from vface_torch.utils.platform import device_from_env

    dev = device_from_env()
    cfg = FV2VConfig.tiny() if args.tiny else FV2VConfig()
    size = cfg.image_size if args.tiny else args.size
    with Image.open(args.source) as img:
        src = np.asarray(img.convert("RGB").resize((size, size)), np.float32) / 255.0
    frames = torch.from_numpy(read_driving(args.driving)).to(dev)
    frames = resize_bilinear(frames, size, size)
    gen = load_generator(cfg, args.params, dev)
    src_b = torch.from_numpy(src).to(dev)[None]
    outs = []
    with torch.inference_mode():
        for i in range(frames.shape[0]):
            outs.append(gen(src_b, frames[i:i + 1])[0].cpu().numpy())
    out_u8 = (np.clip(np.stack(outs), 0, 1) * 255).astype(np.uint8)
    write_avi(args.out, out_u8, fps=args.fps)
    print(f"[done] {args.out}: {len(outs)} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
