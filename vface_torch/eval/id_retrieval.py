"""ID retrieval: top-1 / top-5 accuracy and mean cosine (port of ``vface_tpu/eval/id_retrieval.py``).

Each swapped result is embedded with ArcFace IR-SE-50 and retrieved against
the gallery of source identities: top-k counts a hit when the true source is
among the k nearest gallery embeddings. One batched embedding pass and one
(N, M) product.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vface_torch.eval._common import eval_net, extract
from vface_torch.models.arcface import IRSE50, arcface_preprocess
from vface_torch.ops.warp import resize_bilinear

# per-dataset preserve lists of the reference's retrieval
RETRIEVAL_PRESERVE = {
    "celeba": (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12),
    "ffhq": (1, 2, 3, 5, 6, 7, 9),
    "ff++": (1, 2, 4, 5, 8, 9),
    "none": tuple(range(21)),
}


def mask_crop(images01: np.ndarray, label_masks: np.ndarray, data_name: str = "celeba") -> np.ndarray:
    """The reference's mask-aware retrieval preprocessing: the image resized
    bilinearly to 112^2, the integer parse labels binarised by the dataset's
    preserve list and resized bilinearly to 112^2 as a continuous map (both
    without antialiasing, as JAX's), multiplied in [-1, 1] (masked-out pixels
    become mid-grey). images01 (N, H, W, 3) in [0, 1]; label_masks (N, Hm, Wm)
    -> [0, 1] images (N, 112, 112, 3) for :func:`embed_faces`."""
    img = resize_bilinear(torch.from_numpy(np.asarray(images01, np.float32)), 112, 112, antialias=False)
    binary = np.isin(np.asarray(label_masks), np.asarray(RETRIEVAL_PRESERVE[data_name])).astype(np.float32)
    m = resize_bilinear(torch.from_numpy(binary)[..., None], 112, 112, antialias=False)
    return (((img * 2.0 - 1.0) * m + 1.0) * 0.5).numpy()


def embed_faces(params, images01, model=None, batch: int = 32, device="cuda") -> np.ndarray:
    """[0, 1] face images -> L2-normalised (N, 512) embeddings; ``params`` an
    ``IRSE50`` state dict (or ``model``, the module)."""
    net = eval_net(IRSE50, model if model is not None else params, device)

    def f(x):
        e = net(arcface_preprocess(x))
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    return extract(f, images01, batch, net)


def id_retrieval(swapped_emb: np.ndarray, gallery_emb: np.ndarray, true_ids: np.ndarray,
                 topk: tuple = (1, 5)) -> Dict[str, float]:
    """swapped_emb (N, 512), gallery_emb (M, 512), true_ids (N,) gallery indices ->
    {"top1", "top5", "mean_cosine"}."""
    sims = swapped_emb @ gallery_emb.T
    order = np.argsort(-sims, axis=1)
    res = {}
    for k in topk:
        res[f"top{k}"] = float((order[:, :k] == true_ids[:, None]).any(axis=1).mean())
    res["mean_cosine"] = float(sims[np.arange(len(true_ids)), true_ids].mean())
    return res
