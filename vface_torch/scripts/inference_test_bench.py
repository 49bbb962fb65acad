"""The image test bench: the port's ``scripts/inference_test_bench.py``.

Swaps fixed source / target pairs (the CelebA-HQ / FFHQ / FF++ bench layout:
sources and targets paired by sorted file order, each target's parse map
under ``--mask_dir`` by the target's name) with the plain 2-chunk CFG DDIM of
:func:`vface_torch.pipelines.image_swap.run_test_bench` in batches of
``--batch``, and writes one PNG a pair, ``<outdir>/<target name>.png``.

    VFACE_PLATFORM=cpu python -m vface_torch.scripts.inference_test_bench --tiny \\
        --src_dir S --tar_dir T --mask_dir M --outdir out
    python -m vface_torch.scripts.inference_test_bench --src_dir S --tar_dir T --mask_dir M

Runs on CUDA, and raises without a card, unless ``VFACE_PLATFORM=cpu``. The
flags are the JAX CLI's. Without ``--params`` / ``--aux_params`` the weights
are the port's seeded init (``--seed``; the landmark net from its shipped
weights), which is not the JAX package's; the npz files the JAX package's
``save_params_npz`` writes load as they are (``--aux_params``: the landmark
net's). Every batch starts from the same x_T (a generator seeded with 42, as
the JAX CLI's ``PRNGKey(42)``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src_dir", required=True)
    ap.add_argument("--tar_dir", required=True)
    ap.add_argument("--mask_dir", default=None)
    ap.add_argument("--outdir", default="results/test_bench")
    ap.add_argument("--params", default=None, help="npz params snapshot (else the port's seeded init)")
    ap.add_argument("--aux_params", default=None, help="npz with the landmark net's params")
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from vface_torch.data.datasets import test_bench_pairs
    from vface_torch.io.image import write_png
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.image_swap import ImageSwapOptions, run_test_bench
    from vface_torch.runtime.checkpoint import load_params_npz
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
    else:
        aux = init_aux_params(torch.Generator(device=device).manual_seed(args.seed + 1))

    opts = ImageSwapOptions(ddim_steps=args.ddim_steps, cfg_scale=args.scale, image_size=cfg.image_size)
    pairs = test_bench_pairs(args.src_dir, args.tar_dir, args.mask_dir, cfg.image_size)
    os.makedirs(args.outdir, exist_ok=True)
    n = 0
    for name, out01 in run_test_bench(model, aux, pairs, opts, args.batch):
        write_png(os.path.join(args.outdir, f"{name}.png"), (np.clip(out01, 0, 1) * 255).astype(np.uint8))
        n += 1
    print(f"saved {n} swapped images to {args.outdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
