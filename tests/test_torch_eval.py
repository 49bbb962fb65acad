"""The port's evaluation nets and metrics (``vface_torch/eval``) against the JAX package's.

Each net is built from one seeded Flax tree (its structure from
``jax.eval_shape``, nothing is compiled for the init; conv kernels
He-normal for the ReLU nets (``he_tree``), LeCun-normal for IR-SE-50, frozen-BN means N(0, 0.05^2) and variances in [0.5, 1.5], so
that a wrong BN epsilon or axis shows) converted by
``vface_torch.utils.convert.from_flax_eval``, and fed the same seeded
inputs, fp32 on the CPU, at small sizes: InceptionV3 at 75^2, the ResNet-50
nets (Hopenet, FaceReconNet) at 64^2 through their own forward, and through
``head_pose`` / ``face_coeffs`` (which resize to 224^2). Features within 1e-4
of each output's peak. The metrics (``frechet_distance``, ``id_retrieval``,
``mask_crop``, ``pose_l2``, ``expression_l2``), the temporal functions and
the BFM functions against JAX's on seeded inputs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, he_tree, np_tree, seeded_flax_params, t
from vface_torch.eval import bfm as TB
from vface_torch.eval import expression as TE
from vface_torch.eval import fid as TF
from vface_torch.eval import pose as TP
from vface_torch.eval import temporal as TT
from vface_torch.utils.convert import from_flax_eval

# the package exports the function ``id_retrieval`` under the module's name, as the JAX package does
TI = importlib.import_module("vface_torch.eval.id_retrieval")

R = np.random.default_rng(44)


def _peak_close(got, want, rel=1e-4):
    want = np.asarray(want)
    close(got, want, atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def nets():
    from vface_tpu.eval.expression import FaceReconNet
    from vface_tpu.eval.fid import InceptionV3Pool3
    from vface_tpu.eval.pose import Hopenet
    from vface_tpu.models.arcface import IRSE50

    z = lambda s: jnp.zeros((1, s, s, 3))
    trees = dict(inception=he_tree(seeded_flax_params(InceptionV3Pool3(), z(75), seed=1)),
                 hopenet=he_tree(seeded_flax_params(Hopenet(), z(64), seed=2)),
                 facerecon=he_tree(seeded_flax_params(FaceReconNet(), z(64), seed=3)),
                 arcface=seeded_flax_params(IRSE50(), z(112), seed=4))
    return dict(trees=trees, state=from_flax_eval(np_tree(trees)),
                jax=dict(inception=InceptionV3Pool3(), hopenet=Hopenet(), facerecon=FaceReconNet(), arcface=IRSE50()))


def _images(n, s, seed):
    return np.random.default_rng(seed).uniform(size=(n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("name,cls,size", [("inception", TF.InceptionV3Pool3, 75), ("hopenet", TP.Hopenet, 64),
                                           ("facerecon", TE.FaceReconNet, 64)])
def test_eval_nets_match_jax(nets, name, cls, size):
    x = _images(2, size, seed=len(name)) * 2 - 1
    want = nets["jax"][name].apply({"params": nets["trees"][name]}, jnp.asarray(x))
    net = cls()
    net.load_state_dict(nets["state"][name])
    with torch.inference_mode():
        got = net(t(x))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _peak_close(g, w)


def test_frozen_bn_epsilon_and_pools_are_inceptions():
    """ConvBN's BatchNorm takes eps 1e-3; InceptionA/C and Mixed_7b average
    without the padding; Mixed_7c pools by max."""
    m = TF.InceptionV3Pool3()
    assert m.Conv2d_1a.bn.eps == 1e-3 and m.Mixed_7c.pool == "max" and m.Mixed_7b.pool == "avg"
    x = torch.ones((1, 4, 3, 3))
    assert torch.equal(TF._avg3(x), x)  # the padding is not counted


def test_feature_entry_points_match_jax(nets):
    """head_pose and face_coeffs (224^2, antialiased resize), embed_faces (the
    ArcFace chain, normalised) and inception_features on 3 images of 64^2."""
    from vface_tpu.eval.expression import face_coeffs
    from vface_tpu.eval.fid import inception_preprocess
    from vface_tpu.eval.id_retrieval import embed_faces
    from vface_tpu.eval.pose import head_pose

    x = _images(3, 64, seed=7)
    tr, st = nets["trees"], nets["state"]
    _peak_close(TP.head_pose(st["hopenet"], x, device="cpu"), head_pose(tr["hopenet"], x))
    _peak_close(TE.face_coeffs(st["facerecon"], x, device="cpu"), face_coeffs(tr["facerecon"], x))
    _peak_close(TI.embed_faces(st["arcface"], x, device="cpu"), embed_faces(tr["arcface"], x))
    _peak_close(TF.inception_preprocess(t(x)), inception_preprocess(jnp.asarray(x)))


def test_frechet_distance_and_statistics_match_jax():
    from vface_tpu.eval.fid import activation_statistics, frechet_distance

    a, b = R.normal(size=(40, 8)), R.normal(size=(30, 8)) * 1.3 + 0.2
    mu1, s1 = TF.activation_statistics(a)
    mu2, s2 = TF.activation_statistics(b)
    jm1, js1 = activation_statistics(a)
    np.testing.assert_array_equal(mu1, jm1)
    np.testing.assert_array_equal(s1, js1)
    assert TF.frechet_distance(mu1, s1, mu2, s2) == frechet_distance(mu1, s1, mu2, s2)
    assert TF.frechet_distance(mu1, s1, mu1, s1) == frechet_distance(mu1, s1, mu1, s1) >= 0.0


def test_id_retrieval_and_mask_crop_match_jax():
    from vface_tpu.eval.id_retrieval import id_retrieval, mask_crop

    e = R.normal(size=(6, 16))
    g = R.normal(size=(9, 16))
    e, g = e / np.linalg.norm(e, axis=1, keepdims=True), g / np.linalg.norm(g, axis=1, keepdims=True)
    ids = np.asarray([0, 3, 5, 1, 8, 2])
    assert TI.id_retrieval(e, g, ids) == id_retrieval(e, g, ids)
    imgs = _images(2, 80, seed=9)
    labels = R.integers(0, 19, size=(2, 50, 50))
    for data in ("celeba", "ffhq", "ff++", "none"):
        close(TI.mask_crop(imgs, labels, data), mask_crop(imgs, labels, data), atol=1e-6)


def test_pose_and_expression_metrics_match_jax():
    from vface_tpu.eval.expression import expression_l2
    from vface_tpu.eval.pose import logits_to_degrees, pose_l2

    logits = R.normal(size=(3, 66)).astype(np.float32) * 3
    close(TP.logits_to_degrees(t(logits)), logits_to_degrees(jnp.asarray(logits)), atol=1e-4)
    a, b = R.normal(size=(4, 3)) * 20, R.normal(size=(4, 3)) * 20
    assert TP.pose_l2(a, b) == pytest.approx(pose_l2(a, b), rel=1e-12)
    ca, cb = R.normal(size=(4, 257)), R.normal(size=(4, 257))
    assert TE.expression_l2(ca, cb) == pytest.approx(expression_l2(ca, cb), rel=1e-12)
    assert (TE.EXP_SLICE, TE.GAMMA_SLICE) == (slice(80, 144), slice(227, 254))


def test_temporal_metrics_match_jax(nets):
    from vface_tpu.eval import temporal as JT

    frames = _images(4, 48, seed=11)
    flow = (R.normal(size=(3, 48, 48, 2)) * 1.5).astype(np.float32)
    mask = (R.uniform(size=(4, 48, 48, 1)) > 0.4).astype(np.float32)
    assert TT.warp_error(frames, flow) == pytest.approx(JT.warp_error(jnp.asarray(frames), jnp.asarray(flow)),
                                                         rel=1e-5)
    assert TT.warp_error(frames, flow, mask) == pytest.approx(
        JT.warp_error(jnp.asarray(frames), jnp.asarray(flow), jnp.asarray(mask)), rel=1e-5)
    tr, st = nets["trees"]["arcface"], nets["state"]["arcface"]
    got = TT.evaluate_temporal(st, frames, flow, device="cpu")
    want = JT.evaluate_temporal(tr, frames, flow)
    assert set(got) == set(want) == {"tl_id", "tg_id", "warp_error"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    assert TT.tl_id(st, frames, device="cpu") == pytest.approx(JT.tl_id(tr, jnp.asarray(frames)), rel=1e-5)
    assert TT.tg_id(st, frames, device="cpu") == pytest.approx(JT.tg_id(tr, jnp.asarray(frames)), rel=1e-5)


def _mesh(v=60, f=90, seed=12):
    r = np.random.default_rng(seed)
    return dict(mean_shape=r.normal(size=(v * 3,)).astype(np.float32) * 0.5,
                id_base=r.normal(size=(v * 3, 80)).astype(np.float32) * 0.01,
                exp_base=r.normal(size=(v * 3, 64)).astype(np.float32) * 0.01,
                mean_tex=r.uniform(50, 200, size=(v * 3,)).astype(np.float32),
                tex_base=r.normal(size=(v * 3, 80)).astype(np.float32),
                faces=r.integers(0, v, size=(f, 3)).astype(np.int32),
                coeffs=(r.normal(size=(1, 257)) * 0.3).astype(np.float32))


def test_bfm_functions_match_jax():
    from vface_tpu.eval import bfm as JB

    m = _mesh()
    j = {k: jnp.asarray(v) for k, v in m.items()}
    tm = {k: t(v) for k, v in m.items()}
    c, jc = TB.split_coeff(tm["coeffs"]), JB.split_coeff(j["coeffs"])
    for a, b in zip(c, jc):
        close(a, b, atol=0.0)
    shape = TB.compute_shape(tm["mean_shape"], tm["id_base"], tm["exp_base"], c.id, c.exp)
    jshape = JB.compute_shape(j["mean_shape"], j["id_base"], j["exp_base"], jc.id, jc.exp)
    close(shape, jshape, atol=1e-5)
    close(TB.compute_texture(tm["mean_tex"], tm["tex_base"], c.tex),
          JB.compute_texture(j["mean_tex"], j["tex_base"], jc.tex), atol=1e-3)
    close(TB.compute_rotation(c.angle), JB.compute_rotation(jc.angle), atol=1e-6)
    normals = TB.vertex_normals(shape, tm["faces"])
    close(normals, JB.vertex_normals(jshape, j["faces"]), atol=1e-5)
    close(TB.sh_illumination(normals, c.gamma), JB.sh_illumination(jnp.asarray(normals.numpy()), jc.gamma),
          atol=1e-5)
    close(TB.project(shape), JB.project(jshape), atol=1e-3)
    img = TB.render_coeffs(tm["coeffs"], tm["mean_shape"], tm["id_base"], tm["exp_base"], tm["mean_tex"],
                           tm["tex_base"], tm["faces"], size=64)
    jimg = JB.render_coeffs(j["coeffs"], j["mean_shape"], j["id_base"], j["exp_base"], j["mean_tex"],
                            j["tex_base"], j["faces"], size=64)
    assert img.shape == (64, 64, 3) and float(img.abs().sum()) > 0
    close(img, jimg, atol=1e-5)


def test_splat_render_resolves_depth_as_jax():
    """Distinct depths: the nearest vertex of each pixel owns it; equal depths
    (within 1e-6) share the pixel: its colour is their mean, in both."""
    from vface_tpu.eval import bfm as JB

    r = np.random.default_rng(13)
    v = 400
    proj = np.stack([r.uniform(0, 15, v), r.uniform(0, 15, v), r.permutation(v) * 0.01 + 1.0], -1).astype(np.float32)
    colors = r.uniform(size=(v, 3)).astype(np.float32)
    got = TB.splat_render(t(proj), t(colors), size=16)
    close(got, JB.splat_render(jnp.asarray(proj), jnp.asarray(colors), size=16), atol=1e-6)
    tie = np.asarray([[3.0, 4.0, 2.0], [3.2, 4.1, 2.0], [3.0, 4.0, 5.0]], np.float32)
    cols = np.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], np.float32)
    got = TB.splat_render(t(tie), t(cols), size=8)
    close(got[4, 3], [0.5, 0.5, 0.0], atol=1e-7)
    close(got, JB.splat_render(jnp.asarray(tie), jnp.asarray(cols), size=8), atol=1e-7)


def test_from_flax_eval_converts_every_net(nets):
    for name, cls in (("inception", TF.InceptionV3Pool3), ("hopenet", TP.Hopenet), ("facerecon", TE.FaceReconNet)):
        want = set(cls().state_dict())
        assert set(nets["state"][name]) == want, name
    from vface_torch.models.arcface import IRSE50

    assert set(nets["state"]["arcface"]) == set(IRSE50().state_dict())
