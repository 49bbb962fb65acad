"""Combine CelebAMask-HQ per-attribute masks into ``Overall_mask`` index images: the port's ``scripts/process_celeba_masks.py``.

For each CelebA-HQ id the per-attribute binary masks
(``CelebA-HQ-mask/<i // 2000>/{i:05d}_<attr>.png``, 512^2, 255 = attribute)
are merged into one 512^2 index image whose value is the attribute's index + 1
in the fixed 18-attribute order (background 0); a later attribute overwrites
an earlier one where they overlap, as REFace's ``process_CelebA_mask.py``
assigns them in turn. Output: ``Overall_mask/{i}.png``, the masks that
:class:`vface_torch.data.datasets.CelebATrainDataset` reads.

    python -m vface_torch.scripts.process_celeba_masks --mask_root CelebAMask-HQ/CelebA-HQ-mask --n 30000
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# 19 classes in all: skin=1, nose=2, ... cloth=18, background=0
CELEBAHQ_LABEL_LIST = [
    "skin", "nose", "eye_g", "l_eye", "r_eye",
    "l_brow", "r_brow", "l_ear", "r_ear", "mouth",
    "u_lip", "l_lip", "hair", "hat", "ear_r",
    "neck_l", "neck", "cloth",
]


def combine_one(mask_root: str, i: int, size: int = 512) -> np.ndarray:
    """Merge id ``i``'s attribute masks -> (size, size) uint8 index image."""
    from PIL import Image

    mask = np.zeros((size, size), np.uint8)
    sub = os.path.join(mask_root, str(i // 2000))
    for ind, cate in enumerate(CELEBAHQ_LABEL_LIST):
        p = os.path.join(sub, f"{i:05d}_{cate}.png")
        if not os.path.exists(p):
            continue
        with Image.open(p) as img:
            im = np.asarray(img.convert("L"))
        mask[im == 255] = ind + 1
    return mask


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mask_root", default="dataset/FaceData/CelebAMask-HQ/CelebA-HQ-mask",
                    help="per-attribute mask tree (subdirs 0..14 of 2000 ids each)")
    ap.add_argument("--out", default=None, help="default: <mask_root>/Overall_mask")
    ap.add_argument("--n", type=int, default=30000)
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.join(args.mask_root, "Overall_mask")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(args.n):
        Image.fromarray(combine_one(args.mask_root, i)).save(os.path.join(out_dir, f"{i}.png"))
        if i % 1000 == 0:
            print(f"[masks] {i}/{args.n}")
    print(f"[masks] wrote {args.n} combined masks to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
