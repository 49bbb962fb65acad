"""evaluate_all, the quantitative-analysis orchestrator (port of ``vface_tpu/eval/harness.py``).

Given a results directory, the dataset images and the source / target
directories: FID, ID retrieval (top-1 / top-5 / cosine), pose L2 and
expression L2, and a timestamped report line appended to ``out_path``. The
feature extraction runs batched on the card (unless the caller asks for the
CPU), at full fp32: each extraction turns TF32 off for its own calls.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def _load_dir(path: str, size: int = 256, limit: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    files = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg")))[:limit]
    imgs = [np.asarray(Image.open(os.path.join(path, f)).convert("RGB").resize((size, size)), np.float32) / 255.0
            for f in files]
    return np.stack(imgs) if imgs else np.empty((0, size, size, 3), np.float32)


def evaluate_all(results_dir: str, dataset_dir: str, source_dir: str, target_dir: str, eval_params: Dict,
                 out_path: Optional[str] = None, limit: Optional[int] = None, device="cuda",
                 timings: Optional[dict] = None) -> Dict[str, float]:
    """``eval_params``: any of {"inception", "arcface", "hopenet", "facerecon"},
    each a state dict of ``InceptionV3Pool3``, ``IRSE50``, ``Hopenet``,
    ``FaceReconNet`` (:func:`vface_torch.utils.convert.from_flax_eval`) or
    the module itself. With ``timings`` (a dict) each metric's wall seconds
    are added to it."""
    from vface_torch.eval.expression import expression_l2, face_coeffs
    from vface_torch.eval.fid import compute_fid
    from vface_torch.eval.id_retrieval import embed_faces, id_retrieval
    from vface_torch.eval.pose import head_pose, pose_l2

    results = _load_dir(results_dir, limit=limit)
    dataset = _load_dir(dataset_dir, limit=limit)
    sources = _load_dir(source_dir, limit=limit)
    targets = _load_dir(target_dir, limit=limit)
    clock = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + now - clock[0]
        clock[0] = now

    report: Dict[str, float] = {}
    mark("load")
    if "inception" in eval_params and len(dataset):
        report["fid"] = compute_fid(eval_params["inception"], results, dataset, device=device)
        mark("fid")
    if "arcface" in eval_params and len(sources):
        swapped_emb = embed_faces(eval_params["arcface"], results, device=device)
        gallery_emb = embed_faces(eval_params["arcface"], sources, device=device)
        ids = np.arange(min(len(swapped_emb), len(gallery_emb)))
        r = id_retrieval(swapped_emb[: len(ids)], gallery_emb, ids)
        report.update({f"id_{k}": v for k, v in r.items()})
        mark("id_retrieval")
    if "hopenet" in eval_params and len(targets):
        n = min(len(results), len(targets))
        report["pose_l2"] = pose_l2(head_pose(eval_params["hopenet"], results[:n], device=device),
                                    head_pose(eval_params["hopenet"], targets[:n], device=device))
        mark("pose")
    if "facerecon" in eval_params and len(targets):
        n = min(len(results), len(targets))
        report["expression_l2"] = expression_l2(face_coeffs(eval_params["facerecon"], results[:n], device=device),
                                                face_coeffs(eval_params["facerecon"], targets[:n], device=device))
        mark("expression")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps({"ts": time.strftime("%Y%m%d_%H%M%S"), "results_dir": results_dir, **report}) + "\n")
    return report
