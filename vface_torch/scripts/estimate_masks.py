"""Precompute BiSeNet masks for a dataset folder, or combine CelebAMask-HQ attribute masks: the port's ``scripts/estimate_masks.py``.

``bisenet``: one batched BiSeNet pass per ``--batch`` images of ``--indir``
(REFace's ``esitmate_FFHQ_mask.py``), each class map (512^2) written as
``<outdir>/<stem>.png``. ``--params`` is an npz of BiSeNet's tree (the JAX
package's ``save_params_npz`` layout); without it the weights are seeded
(seed 0), where JAX's script inits from ``PRNGKey(0)``. Runs on CUDA, and
raises without a card, unless ``VFACE_PLATFORM=cpu``.

``celeba``: per-attribute CelebAMask-HQ masks (``<anno_dir>/<i // 2000>/{i:05d}_<attr>.png``)
-> ``<outdir>/{i}.png`` index images, the attribute's index + 1 in this
script's order where its mask is over 127, a later attribute over an earlier one.

    python -m vface_torch.scripts.estimate_masks bisenet --indir frames/ --outdir masks/ [--params bisenet.npz]
    python -m vface_torch.scripts.estimate_masks celeba --anno_dir CelebA-HQ-mask --outdir Overall_mask --count 30000
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# CelebAMask-HQ per-attribute file suffix -> class index (its position + 1)
CELEBA_ATTRS = [
    "skin", "l_brow", "r_brow", "l_eye", "r_eye", "eye_g", "l_ear", "r_ear",
    "ear_r", "nose", "mouth", "u_lip", "l_lip", "neck", "neck_l", "cloth",
    "hair", "hat",
]


def combine_celeba_masks(anno_dir: str, out_dir: str, count: int = 30000) -> int:
    """Merge per-attribute binary masks into Overall_mask index images; the number written."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for i in range(count):
        sub = f"{i // 2000}"
        overall = None
        for ci, attr in enumerate(CELEBA_ATTRS, start=1):
            p = os.path.join(anno_dir, sub, f"{i:05d}_{attr}.png")
            if not os.path.exists(p):
                continue
            with Image.open(p) as img:
                m = np.asarray(img.convert("L")) > 127
            if overall is None:
                overall = np.zeros(m.shape, np.uint8)
            overall[m] = ci
        if overall is not None:
            Image.fromarray(overall).save(os.path.join(out_dir, f"{i}.png"))
            done += 1
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bisenet", help="run BiSeNet over a folder of images")
    b.add_argument("--indir", required=True)
    b.add_argument("--outdir", required=True)
    b.add_argument("--params", default=None, help="npz BiSeNet params")
    b.add_argument("--batch", type=int, default=8)
    c = sub.add_parser("celeba", help="combine CelebAMask-HQ attribute masks")
    c.add_argument("--anno_dir", required=True)
    c.add_argument("--outdir", required=True)
    c.add_argument("--count", type=int, default=30000)
    args = ap.parse_args(argv)

    if args.cmd == "celeba":
        n = combine_celeba_masks(args.anno_dir, args.outdir, args.count)
        print(f"combined {n} Overall_mask images into {args.outdir}")
        return 0

    import torch

    from vface_torch.io.image import write_png
    from vface_torch.models.bisenet import parse_faces
    from vface_torch.runtime.checkpoint import read_flat_npz
    from vface_torch.scripts.crop_and_mask import aux_nets, image_files, load_batch
    from vface_torch.utils.convert import flax_tree_to_state_dict
    from vface_torch.utils.platform import device_from_env

    dev = device_from_env()
    model = aux_nets(("bisenet",), device=dev)["bisenet"]
    if args.params:
        model.load_state_dict(flax_tree_to_state_dict(read_flat_npz(args.params)))
    os.makedirs(args.outdir, exist_ok=True)
    files = image_files(args.indir)
    with torch.inference_mode():
        for s0 in range(0, len(files), args.batch):
            chunk = files[s0:s0 + args.batch]
            seg = parse_faces(model, load_batch(args.indir, chunk, dev)).cpu().numpy()
            for f, m in zip(chunk, seg):
                write_png(os.path.join(args.outdir, os.path.splitext(f)[0] + ".png"), m.astype(np.uint8))
    print(f"wrote {len(files)} masks to {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
