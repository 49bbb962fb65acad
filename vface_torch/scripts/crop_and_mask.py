"""Align faces and write their parsing masks, for a folder of images: the port's ``scripts/crop_and_mask.py``.

Each image's 68 landmarks (:class:`~vface_torch.preprocess.landmarks.LandmarkNet`)
give the FFHQ quad (:func:`~vface_torch.preprocess.align.compute_quad`); the
quad crop at ``--size`` goes to ``<outdir>/crops/<stem>.png`` and its BiSeNet
class map (parsed at 512^2, resized back with JAX's nearest rule) to
``<outdir>/masks/<stem>.png`` (REFace's ``Crop_and_mask.py``, batched). The
images of one ``--batch`` must share a size.

    python -m vface_torch.scripts.crop_and_mask --indir faces/ --outdir cropped/ --size 512 [--aux_params aux.npz]

``--aux_params`` is an npz with ``landmark/...`` and ``bisenet/...`` groups
(the JAX package's ``save_params_npz`` layout); without it the landmark net
takes its shipped weights and BiSeNet seeded ones (a CPU generator seeded
with 0, the same on every device), where JAX's
script inits both from ``PRNGKey(0)``. Runs on CUDA, and raises without a
card, unless ``VFACE_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def image_files(indir: str):
    return sorted(f for f in os.listdir(indir) if f.lower().endswith((".png", ".jpg", ".jpeg")))


def load_batch(indir: str, files, device):
    """The images as one (B, H, W, 3) float32 tensor in [0, 1] on ``device``."""
    import torch

    from vface_torch.io.image import read_png

    imgs = [read_png(os.path.join(indir, f), "RGB").astype(np.float32) / 255.0 for f in files]
    return torch.from_numpy(np.stack(imgs)).to(device)


def aux_nets(names, params_path: str = None, device="cuda") -> dict:
    """The aux modules ``names`` (of "landmark", "bisenet") on ``device`` in eval
    mode: seeded (:func:`vface_torch.utils.convert.init_aux_params` with a CPU
    generator seeded with 0, so that every device gets the same weights; the
    landmark net's shipped weights), then the groups an npz holds."""
    import torch

    from vface_torch.models.bisenet import BiSeNet
    from vface_torch.preprocess.landmarks import LandmarkNet
    from vface_torch.runtime.checkpoint import load_params_npz
    from vface_torch.utils.convert import init_aux_params

    state = init_aux_params(torch.Generator().manual_seed(0))
    if params_path:
        state.update(load_params_npz(params_path))
    classes = {"landmark": LandmarkNet, "bisenet": BiSeNet}
    nets = {}
    for name in names:
        with torch.device(device):
            nets[name] = classes[name]()
        nets[name].load_state_dict(state[name])
        nets[name].eval()
    return nets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--indir", required=True)
    ap.add_argument("--outdir", default="cropped")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--aux_params", default=None)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from vface_torch.io.image import write_png
    from vface_torch.models.bisenet import parse_faces
    from vface_torch.ops.warp import resize_nearest
    from vface_torch.preprocess.align import compute_quad, quad_crop
    from vface_torch.utils.platform import device_from_env

    dev = device_from_env()
    nets = aux_nets(("landmark", "bisenet"), args.aux_params, dev)
    os.makedirs(os.path.join(args.outdir, "crops"), exist_ok=True)
    os.makedirs(os.path.join(args.outdir, "masks"), exist_ok=True)
    files = image_files(args.indir)
    with torch.inference_mode():
        for s0 in range(0, len(files), args.batch):
            chunk = files[s0:s0 + args.batch]
            imgs = load_batch(args.indir, chunk, dev)
            quad, _ = compute_quad(nets["landmark"](imgs))
            crops = quad_crop(imgs, quad, args.size)
            seg = resize_nearest(parse_faces(nets["bisenet"], crops), args.size, args.size)
            for f, c, m in zip(chunk, crops.cpu().numpy(), seg.cpu().numpy()):
                stem = os.path.splitext(f)[0]
                write_png(os.path.join(args.outdir, "crops", stem + ".png"), (np.clip(c, 0, 1) * 255).astype(np.uint8))
                write_png(os.path.join(args.outdir, "masks", stem + ".png"), m.astype(np.uint8))
    print(f"processed {len(files)} images into {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
