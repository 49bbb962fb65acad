"""The video swap's aux nets and preprocessing against the JAX package.

fp32 on the CPU, the same seeded numpy inputs and weights on both sides:
``preprocess/masks.py`` and ``preprocess/align.py`` (1e-5; the perspective
coefficients 1e-4 relative), ``LandmarkNet`` with the shipped weights
(landmarks within 1e-3 px), BiSeNet at parser size 64 (logits within 1e-4 of
their peak, class maps equal), RAFT with two iterations at 64^2 (flow within
1e-4 px), and the aux-tree conversion. The Flax nets' params come from
``seeded_flax_params`` (shapes by ``jax.eval_shape``, values by numpy), so no
Flax init is compiled; the JAX nets run eagerly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, seeded_flax_params, t
from vface_tpu.models import bisenet as JB
from vface_tpu.models import raft as JR
from vface_tpu.preprocess import align as JAl
from vface_tpu.preprocess import landmarks as JLm
from vface_tpu.preprocess import masks as JM
from vface_tpu.preprocess.synthetic_faces import canonical_landmarks as jax_canonical_landmarks
from vface_torch.models import bisenet as TB
from vface_torch.models import raft as TR
from vface_torch.preprocess import align as TAl
from vface_torch.preprocess import detector as TDet
from vface_torch.preprocess import landmarks as TLm
from vface_torch.preprocess import masks as TM
from vface_torch.utils.convert import AUX_PARTS, from_flax_aux, init_aux_params


def _smooth_images(shape, seed):
    """Seeded smooth images in [0, 1]: low-frequency noise, bilinearly upsampled."""
    b, h, w, _ = shape
    base = torch.from_numpy(np.random.default_rng(seed).normal(size=(b, 3, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    return (torch.sigmoid(up).permute(0, 2, 3, 1)).numpy().copy()


# ------------------------------------------------------------------- masks
def test_masks_match_jax():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 19, size=(2, 16, 16)).astype(np.int32)
    img = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    close(TM.celeba_to_seg12(t(seg)), JM.celeba_to_seg12(jnp.asarray(seg)), atol=0)
    close(TM.region_mask(t(seg), (1, 4, 17)), JM.region_mask(jnp.asarray(seg), (1, 4, 17)), atol=0)
    for got, want in zip(TM.inpaint_inputs(t(img), t(seg)), JM.inpaint_inputs(jnp.asarray(img), jnp.asarray(seg))):
        close(got, want, atol=1e-5)
    seg12 = np.asarray(JM.celeba_to_seg12(jnp.asarray(seg)))
    close(TM.preserve_mask_seg12(t(seg12)), JM.preserve_mask_seg12(jnp.asarray(seg12)), atol=0)
    keep = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)
    close(TM.downsample_mask_to_latent(t(keep), 4), JM.downsample_mask_to_latent(jnp.asarray(keep), 4), atol=1e-5)
    assert TM.TRAIN_REMOVE == JM.TRAIN_REMOVE and TM.FFHQ12_PRESERVE == JM.FFHQ12_PRESERVE


# ------------------------------------------------------------------- align
def _landmarks(b, seed, h=48, w=64):
    """Canonical 68-point faces, scaled, rotated and placed in an (h, w) frame."""
    rng = np.random.default_rng(seed)
    canon = TLm.canonical_landmarks()
    out = []
    for _ in range(b):
        ang = rng.uniform(-0.3, 0.3)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32)
        ctr = np.array([w * rng.uniform(0.4, 0.6), h * rng.uniform(0.4, 0.6)], np.float32)
        out.append(canon @ rot.T * rng.uniform(8, 14) + ctr)
    return np.stack(out).astype(np.float32)


def test_align_matches_jax():
    rng = np.random.default_rng(1)
    lm = _landmarks(3, seed=2)
    frames = rng.uniform(size=(3, 48, 64, 3)).astype(np.float32)
    (quad, qsize), (jquad, jqsize) = TAl.compute_quad(t(lm), 1.1), JAl.compute_quad(jnp.asarray(lm), 1.1)
    # 1e-5 of the coordinates' scale (tens of pixels; fp32 resolves ~4e-6 px at 50)
    close(quad, jquad, atol=1e-5 * float(np.abs(np.asarray(jquad)).max()))
    close(qsize, jqsize, atol=1e-5 * float(np.abs(np.asarray(jqsize)).max()))
    jq = np.asarray(jquad)
    close(TAl.quad_crop(t(frames), t(jq), 32), JAl.quad_crop(jnp.asarray(frames), jnp.asarray(jq), 32), atol=1e-5)
    corners = np.asarray([[0, 0], [0, 32], [32, 32], [32, 0]], np.float32)
    coeffs = np.stack([TAl.perspective_coefficients(q, corners) for q in jq])
    want = np.stack([np.asarray(JAl.perspective_coefficients(q, corners)) for q in jq])
    assert coeffs.dtype == np.float32
    np.testing.assert_allclose(coeffs, want, rtol=1e-4, atol=1e-6)
    crop = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    close(TAl.perspective_warp(t(crop), t(want), 48, 64),
          JAl.perspective_warp(jnp.asarray(crop), jnp.asarray(want), 48, 64), atol=1e-5)
    mask = rng.uniform(size=(3, 32, 32, 1)).astype(np.float32)
    for m in (None, mask):
        got = TAl.paste_back(t(frames), t(crop), t(want), None if m is None else t(m))
        ref = JAl.paste_back(jnp.asarray(frames), jnp.asarray(crop), jnp.asarray(want),
                             None if m is None else jnp.asarray(m))
        close(got, ref, atol=1e-5)


# --------------------------------------------------------------- landmarks
def test_landmark_net_with_shipped_weights_matches_jax():
    """The shipped npz read as data on both sides; a seeded smooth (2, 96, 128, 3)
    image: the heat maps within 1e-4 of their peak, the decoded landmarks
    (argmaxes gated by the fitted layout, then a 3x3 soft-argmax) within 1e-3 px."""
    tree = TLm.load_default_landmark_params()
    jtree = JLm.load_default_landmark_params()
    assert tree is not None and set(tree) == set(jtree)
    x = _smooth_images((2, 96, 128, 3), seed=3)
    net = TLm.LandmarkNet()
    net.load_state_dict(from_flax_aux({"landmark": tree})["landmark"])
    jnet = JLm.LandmarkNet()
    want_heat = jnet.apply({"params": jtree}, jnp.asarray(x), method=JLm.LandmarkNet.heatmaps)
    want = jnet.apply({"params": jtree}, jnp.asarray(x))
    with torch.no_grad():
        heat, got = net.heatmaps(t(x)), net(t(x))
    close(heat, want_heat, atol=1e-4 * float(np.abs(np.asarray(want_heat)).max()))
    assert got.shape == (2, 68, 2)
    close(got, want, atol=1e-3)
    close(TLm.landmarks_to_vector(got), JLm.landmarks_to_vector(want), atol=1e-3)
    np.testing.assert_array_equal(TLm.canonical_landmarks(), jax_canonical_landmarks())


# ----------------------------------------------------------------- BiSeNet
def test_bisenet_matches_jax_at_parser_size_64():
    """Logits within 1e-4 of their peak; class maps (argmax) equal."""
    jnet = JB.BiSeNet()
    params = seeded_flax_params(jnet, jnp.zeros((1, 64, 64, 3)), seed=4)
    net = TB.BiSeNet()
    net.load_state_dict(from_flax_aux({"bisenet": params})["bisenet"])
    x = _smooth_images((2, 32, 32, 3), seed=5)
    jx = JB.parsing_preprocess(jnp.asarray(x), 64)
    close(TB.parsing_preprocess(t(x), 64), jx, atol=1e-5)
    want = jnet.apply({"params": params}, jx)
    with torch.no_grad():
        got = net(TB.parsing_preprocess(t(x), 64))
        seg = TB.parse_faces(net, t(x), 64)
    close(got, want, atol=1e-4 * float(np.abs(np.asarray(want)).max()))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(JB.parse_faces(params, jnp.asarray(x), jnet, 64)))
    assert seg.dtype == torch.int32


# -------------------------------------------------------------------- RAFT
def test_raft_matches_jax_two_iterations_at_64():
    """Two frame pairs at 64^2, RAFTConfig(iters=2): flow within 1e-4 px."""
    cfg = JR.RAFTConfig(iters=2)
    jnet = JR.RAFT(cfg)
    params = seeded_flax_params(jnet, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)), seed=6)
    net = TR.RAFT(TR.RAFTConfig(iters=2))
    net.load_state_dict(from_flax_aux({"raft": params})["raft"])
    x = _smooth_images((3, 64, 64, 3), seed=7) * 2 - 1
    want = jnet.apply({"params": params}, jnp.asarray(x[1:]), jnp.asarray(x[:-1]))
    with torch.no_grad():
        got = net(t(x[1:]), t(x[:-1]))
    assert got.shape == (2, 64, 64, 2)
    close(got, want, atol=1e-4)


# -------------------------------------------------------------- conversion
def test_aux_tree_conversion_and_seeded_init():
    """Each Flax aux tree converts to a state dict that loads strictly into the
    port's module; init_aux_params makes the same keys, seeded, with the
    landmark net and the face detector from the shipped files."""
    trees = {"bisenet": seeded_flax_params(JB.BiSeNet(), jnp.zeros((1, 64, 64, 3))),
             "raft": seeded_flax_params(JR.RAFT(JR.RAFTConfig(iters=1)), jnp.zeros((1, 32, 32, 3)),
                                        jnp.zeros((1, 32, 32, 3))),
             "landmark": TLm.load_default_landmark_params(), "detector": TDet.load_default_detector_params()}
    states = from_flax_aux(trees)
    mods = {"bisenet": TB.BiSeNet(), "raft": TR.RAFT(TR.RAFTConfig(iters=1)), "landmark": TLm.LandmarkNet(),
            "detector": TDet.FaceDetector()}
    assert tuple(states) == AUX_PARTS
    for name, mod in mods.items():
        mod.load_state_dict(states[name])  # strict: same keys and shapes
    a, b = (init_aux_params(torch.Generator().manual_seed(3)) for _ in range(2))
    for name in AUX_PARTS:
        assert a[name].keys() == mods[name].state_dict().keys()
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name])
    assert torch.equal(a["landmark"]["head.weight"], states["landmark"]["head.weight"])
    assert torch.equal(a["detector"]["heat.weight"], states["detector"]["heat.weight"])
    assert a["bisenet"]["cp.resnet.conv1.weight"].abs().max() > 0
