"""Square-crop ground-truth images for FID: the port's ``scripts/create_square_gt_for_fid.py``.

Each image of ``--indir`` is centre-cropped to a square, resized bilinearly
(PIL) to ``--size`` and written as ``<outdir>/<stem>.png``.

    python -m vface_torch.scripts.create_square_gt_for_fid --indir gt/ --outdir gt_square/ --size 512
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(args.indir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        with Image.open(os.path.join(args.indir, f)) as src:
            img = src.convert("RGB")
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        img.resize((args.size, args.size), Image.BILINEAR).save(os.path.join(args.outdir, os.path.splitext(f)[0] + ".png"))
        n += 1
    print(f"wrote {n} square GT images to {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
