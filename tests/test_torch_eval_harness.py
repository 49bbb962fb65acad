"""``vface_torch.eval.harness.evaluate_all`` against the JAX package's on 4 small images.

The four eval nets from seeded Flax trees (as ``tests/test_torch_eval.py``:
He-normal kernels for the ReLU nets, so that Inception's features are of
order 1 and the distance is not all regulariser; perturbed frozen-BN statistics) converted by ``from_flax_eval``; four seeded
64^2 PNGs in each of the results, dataset, source and target directories
(``_load_dir`` resizes them to 256^2, Inception's preprocessing to 299^2,
the pose and expression nets' to 224^2), fp32 on the CPU. Every entry of
the report against JAX's: the ID top-k and the mean cosine, pose L2 and
expression L2 within 1e-4 relative; FID within 1e-3 relative (the Frechet
distance of 4 samples in 2048 dimensions takes square roots of a
rank-deficient covariance product, whose near-zero eigenvalues move the
distance by more than the features' 1e-4). The appended report line.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from _torch_port import he_tree, np_tree, seeded_flax_params
from vface_torch.eval.harness import evaluate_all
from vface_torch.utils.convert import from_flax_eval


def _write(d, seed, n=4, s=64):
    os.makedirs(d)
    imgs = (np.random.default_rng(seed).uniform(size=(n, s, s, 3)) * 255).astype(np.uint8)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(d, f"{i:03d}.png"))


def test_evaluate_all_matches_jax(tmp_path):
    from vface_tpu.eval.expression import FaceReconNet
    from vface_tpu.eval.fid import InceptionV3Pool3
    from vface_tpu.eval.harness import evaluate_all as jax_evaluate_all
    from vface_tpu.eval.pose import Hopenet
    from vface_tpu.models.arcface import IRSE50

    z = lambda s: jnp.zeros((1, s, s, 3))
    trees = dict(inception=he_tree(seeded_flax_params(InceptionV3Pool3(), z(75), seed=1)),
                 hopenet=he_tree(seeded_flax_params(Hopenet(), z(64), seed=2)),
                 facerecon=he_tree(seeded_flax_params(FaceReconNet(), z(64), seed=3)),
                 arcface=seeded_flax_params(IRSE50(), z(112), seed=4))
    dirs = {k: str(tmp_path / k) for k in ("results", "dataset", "sources", "targets")}
    for i, d in enumerate(dirs.values()):
        _write(d, seed=50 + i)
    args = (dirs["results"], dirs["dataset"], dirs["sources"], dirs["targets"])
    timings = {}
    got = evaluate_all(*args, from_flax_eval(np_tree(trees)), out_path=str(tmp_path / "report.jsonl"),
                       device="cpu", timings=timings)
    want = jax_evaluate_all(*args, trees)
    assert set(got) == set(want) == {"fid", "id_top1", "id_top5", "id_mean_cosine", "pose_l2", "expression_l2"}
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-3 if k == "fid" else 1e-4), k
    assert got["fid"] > 0
    assert set(timings) == {"load", "fid", "id_retrieval", "pose", "expression"}
    with open(tmp_path / "report.jsonl") as f:
        line = json.loads(f.read())
    assert line["results_dir"] == dirs["results"] and line["fid"] == got["fid"]
