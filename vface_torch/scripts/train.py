"""Training CLI: REFace training on CelebA-HQ pairs (port of the JAX package's ``scripts/train.py``).

    python -m vface_torch.scripts.train --dataset_dir CelebAMask-HQ --logdir logs/vface [--tiny] [--resume]

The self-supervised inpainting objective (epsilon MSE and the DDIM
reconstruction's ID loss; no perceptual term, as the JAX CLI passes none) on
:class:`~vface_torch.data.datasets.CelebATrainDataset` batches: the reference
is CLIP-preprocessed for the conditioner and kept at 224^2 for ArcFace, the
landmarks are zeros. The model starts from the seeded init (``--seed``), or
with ``--resume`` from the parameters in ``<logdir>/checkpoints/last``: as in
the JAX CLI, the optimizer starts afresh at step 0, so its warm-up restarts.
The batch is ``--batch_size`` on one device. Runs on CUDA; ``VFACE_PLATFORM=cpu``
runs it on the CPU. Exits 1 when the dataset directory holds no image.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset_dir", required=True, help="CelebAMask-HQ root")
    ap.add_argument("--logdir", default="logs/vface")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=100_000)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--scale_lr", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny", action="store_true", help="tiny config smoke mode")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--image_log_every", type=int, default=500)
    ap.add_argument("--ckpt_every", type=int, default=2_000)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from vface_torch.data.datasets import CelebATrainDataset
    from vface_torch.models.clip import clip_preprocess
    from vface_torch.models.ldm import ModelConfig
    from vface_torch.pipelines.train import TrainConfig
    from vface_torch.pipelines.train_driver import DriverConfig, train
    from vface_torch.runtime.checkpoint import TrainCheckpointer
    from vface_torch.utils.platform import device_from_env

    device = device_from_env()
    model_cfg = ModelConfig.tiny(image_size=32) if args.tiny else ModelConfig.sd_v1_inpaint()
    train_cfg = TrainConfig(learning_rate=args.lr)
    driver_cfg = DriverConfig(logdir=args.logdir, max_steps=args.max_steps, log_every=args.log_every,
                              image_log_every=args.image_log_every, ckpt_every=args.ckpt_every,
                              batch_size=args.batch_size, scale_lr=args.scale_lr, seed=args.seed)

    ds = CelebATrainDataset(args.dataset_dir, image_size=model_cfg.image_size)
    if len(ds) == 0:
        print(f"no CelebA-HQ images found under {args.dataset_dir}", file=sys.stderr)
        return 1

    def batches():
        for _ in itertools.count():
            for b in ds.batches(args.batch_size):
                ref01 = b.pop("ref_image01")
                b["ref_clip"] = clip_preprocess(torch.from_numpy(ref01), model_cfg.cond.clip.image_size).numpy()
                b["ref_face01"] = ref01
                b["landmarks"] = np.zeros((ref01.shape[0], 136), np.float32)
                yield b

    init_params = None
    if args.resume:
        state = TrainCheckpointer(os.path.join(args.logdir, "checkpoints")).restore_last()
        if state is not None:
            init_params = state["state"]["params"]
            print(f"[train] resumed from step {state['step']}", flush=True)

    train(model_cfg, train_cfg, driver_cfg, batches(), init_params=init_params, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
