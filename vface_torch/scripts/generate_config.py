"""Pair target videos with source images into the swap-config YAML: the port's ``scripts/generate_config.py``.

Naturally sorted video files / frame subdirectories are matched index-wise
with the naturally sorted source images (REFace's ``generate_config.py``);
the YAML is what ``python -m vface_torch.scripts.vface_video_swap --config``
reads.

    python -m vface_torch.scripts.generate_config --videos videos/ --sources sources/ --out swap_config.yaml
"""

from __future__ import annotations

import argparse
import os
import re


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--videos", required=True, help="dir of videos (.y4m) or frame subdirs")
    ap.add_argument("--sources", required=True, help="dir of source images")
    ap.add_argument("--out", default="swap_config.yaml")
    args = ap.parse_args(argv)

    vids = sorted((os.path.join(args.videos, v) for v in os.listdir(args.videos)), key=natsort_key)
    srcs = sorted((os.path.join(args.sources, s) for s in os.listdir(args.sources)
                   if s.lower().endswith((".png", ".jpg", ".jpeg"))), key=natsort_key)
    with open(args.out, "w") as f:
        for v, s in zip(vids, srcs):
            f.write(f"- video: {v}\n  source: {s}\n")
    print(f"wrote {min(len(vids), len(srcs))} pairs to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
