"""The port's VQ first stage and face-vid2vid generator against the JAX package's.

``VQConfig.tiny()`` and ``FV2VConfig.tiny()`` on seeded numpy weights, fp32 on
the CPU, within 1e-4 (1e-5 where the path is short). The VQ code index is an
argmin over expanded distances, where a different summation order can flip a
near tie: the distance matrices are held at 1e-5 and the indices where the
best and second-best distances differ by more than that. ``warp_volume``
(``grid_sample`` with border padding and aligned corners in the port, JAX's
corner-clamped gather) is held to JAX's function on grids reaching past +-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_flax_params, t
from vface_tpu.models import face_vid2vid as JF
from vface_tpu.models import vq as JV
from vface_torch.models import face_vid2vid as TF
from vface_torch.models import vq as TV
from vface_torch.utils.convert import flax_tree_to_state_dict


@pytest.fixture(scope="module")
def vq():
    jm = JV.VQModel(JV.VQConfig.tiny())
    params = seeded_flax_params(jm, jnp.zeros((1, 32, 32, 3)), seed=4)
    params = jax.tree_util.tree_map(lambda x: x, params)  # a copy, its codebook replaced below
    tm = TV.VQModel(TV.VQConfig.tiny())
    state = flax_tree_to_state_dict(np_tree(params))
    assert "quantize.embedding" in state
    tm.load_state_dict(state)
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    h = np.asarray(jm.apply({"params": params}, x, method=lambda m, x: m.encode(x)))
    # a codebook at the encoder's scale (latents picked and moved), so that the argmin has choices to make
    params["quantize"]["embedding"] = jnp.asarray(
        h.reshape(-1, 4)[np.random.default_rng(1).choice(h.size // 4, 64, replace=False)]
        + 0.05 * np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32))
    tm.quantize.embedding.data.copy_(t(params["quantize"]["embedding"]))
    return jm, params, tm, x, h


def test_vq_encode_and_decode_match_jax(vq):
    jm, params, tm, x, h = vq
    with torch.no_grad():
        close(tm.encode(t(x)), h, atol=1e-5)
        for force in (True, False):
            want = jm.apply({"params": params}, h, force, method=lambda m, h, f: m.decode(h, force_not_quantize=f))
            got = tm.decode(t(h), force_not_quantize=force)
            assert tuple(got.shape) == (2, 32, 32, 3)
            close(got, want, atol=1e-4)
        rec, loss = tm(t(x))
    jrec, jloss = jm.apply({"params": params}, x)
    close(rec, jrec, atol=1e-4)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))


def test_vq_distances_and_indices_match_jax(vq):
    jm, params, tm, _, h = vq
    cb = np.asarray(params["quantize"]["embedding"])
    flat = h.reshape(-1, 4)
    want_d = np.asarray(jnp.sum(flat**2, axis=1, keepdims=True) - 2 * flat @ cb.T + jnp.sum(cb**2, axis=1)[None])
    close(TV.codebook_distances(t(flat), t(cb)), want_d, atol=1e-5)
    zq, loss, idx = jm.apply({"params": params}, h, method=lambda m, h: m.quantize(h))
    with torch.no_grad():
        tzq, tloss, tidx = tm.quantize(t(h))
    srt = np.sort(np.asarray(want_d, np.float64), axis=1)
    clear = (srt[:, 1] - srt[:, 0] > 1e-5).reshape(idx.shape)
    assert clear.mean() > 0.9 and len(np.unique(np.asarray(idx))) > 8
    np.testing.assert_array_equal(tidx.numpy()[clear], np.asarray(idx)[clear])
    close(tzq, zq, atol=1e-5)
    assert abs(float(tloss) - float(loss)) <= 1e-6


def test_vq_straight_through_gradient():
    """z_q = z + sg(e - z): the gradient reaches z unchanged; the codebook
    gets only the codebook term's."""
    q = TV.VectorQuantizer(8, 4)
    with torch.no_grad():
        q.embedding.copy_(torch.randn(8, 4, generator=torch.Generator().manual_seed(0)))
    z = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(1), requires_grad=True)
    zq, loss, idx = q(z)
    (zq.sum() * 0 + zq.pow(2).sum()).backward()
    close(z.grad, 2 * q.embedding.detach()[idx.flatten()].reshape(z.shape), atol=1e-6)


# ------------------------------------------------------------- face-vid2vid


@pytest.fixture(scope="module")
def fv2v():
    cfg = JF.FV2VConfig.tiny()
    s = cfg.image_size
    jm = JF.OcclusionAwareGenerator(cfg)
    params = seeded_flax_params(jm, jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3)), seed=3)
    tm = TF.OcclusionAwareGenerator(TF.FV2VConfig.tiny())
    state = flax_tree_to_state_dict(np_tree(params))
    assert state["appearance.down_0.bn.mean"].ndim == 1 and state["kp_detector.kp_head.weight"].ndim == 5
    tm.load_state_dict(state)
    r = np.random.default_rng(0)
    src = r.uniform(size=(2, s, s, 3)).astype(np.float32)
    drv = r.uniform(size=(2, s, s, 3)).astype(np.float32)
    return jm, params, tm, src, drv


def test_rank5_kernels_map_dhwio_to_oidhw(fv2v):
    jm, params, tm, _, _ = fv2v
    k = np.asarray(params["kp_detector"]["kp_head"]["kernel"])  # (3, 3, 3, I, O)
    np.testing.assert_array_equal(tm.kp_detector.kp_head.weight.detach().numpy(), k.transpose(4, 3, 0, 1, 2))


def test_fv2v_keypoints_and_generator_match_jax(fv2v):
    jm, params, tm, src, drv = fv2v
    with torch.no_grad():
        kp = tm.extract_kp(t(src))
        out = tm(t(src), t(drv))
    want_kp = jm.apply({"params": params}, src, method=jm.extract_kp)
    assert tuple(kp.shape) == (2, 5, 3)
    close(kp, want_kp, atol=1e-5)
    want = jm.apply({"params": params}, src, drv)
    assert tuple(out.shape) == want.shape == (2, 32, 32, 3)
    close(out, want, atol=1e-4)


def test_fv2v_stages_match_jax(fv2v):
    """The appearance volume (JAX's channel split), the canonical keypoints,
    the pose net, the dense motion's flow and occlusion, the 2-D decoder."""
    jm, params, tm, src, drv = fv2v
    cfg = jm.cfg
    ap = lambda m, x: m.appearance(x)
    vol = np.asarray(jm.apply({"params": params}, src, method=ap))  # (B, D, H, W, C)
    x = t(src).permute(0, 3, 1, 2)
    with torch.no_grad():
        tvol = tm.appearance(x)
        close(tvol.permute(0, 2, 3, 4, 1), vol, atol=1e-5)
        kp_c = jm.apply({"params": params}, vol, method=lambda m, v: m.kp_detector(v))
        close(tm.kp_detector(t(vol).permute(0, 4, 1, 2, 3)), kp_c, atol=1e-5)
        pose = jm.apply({"params": params}, drv, method=lambda m, x: m.pose_net(x))
        for g, w in zip(tm.pose_net(t(drv).permute(0, 3, 1, 2)), pose):
            close(g, w, atol=1e-5)
        r = np.random.default_rng(3)
        kd = r.uniform(-0.8, 0.8, size=(2, cfg.num_kp, 3)).astype(np.float32)
        ks = r.uniform(-0.8, 0.8, size=(2, cfg.num_kp, 3)).astype(np.float32)
        flow, occ = jm.apply({"params": params}, vol, kd, ks, method=lambda m, v, a, b: m.dense_motion(v, a, b))
        tflow, tocc = tm.dense_motion(t(vol).permute(0, 4, 1, 2, 3), t(kd), t(ks))
        close(tflow, flow, atol=1e-5)
        close(tocc[:, 0], np.asarray(occ)[..., 0], atol=1e-5)
        feat = r.normal(size=(2, 8, 8, cfg.depth * cfg.reshape_channel)).astype(np.float32)
        dec = jm.apply({"params": params}, feat, method=lambda m, f: m.decoder(f))
        close(tm.decoder(t(feat).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), dec, atol=1e-5)
        yaw, pitch, roll = (r.normal(size=(4, 66)).astype(np.float32) for _ in range(3))
        close(TF.rotation_matrix(*(TF._angles_from_bins(t(a)) for a in (yaw, pitch, roll))),
              JF.rotation_matrix(*(JF._angles_from_bins(a) for a in (yaw, pitch, roll))), atol=1e-6)


def test_warp_volume_matches_jax_past_the_edges():
    """JAX's corner-clamped trilinear gather and the port's border-padded,
    corner-aligned ``grid_sample``: coordinates in [-1.6, 1.6] (beyond the
    volume on every side), the exact edges and the centres of voxels."""
    r = np.random.default_rng(4)
    vol = r.normal(size=(2, 4, 6, 5, 3)).astype(np.float32)  # (B, D, H, W, C)
    grid = r.uniform(-1.6, 1.6, size=(2, 3, 7, 9, 3)).astype(np.float32)
    grid[0, 0, 0, :3] = [[-1, -1, -1], [1, 1, 1], [-1, 1, 0]]
    grid[1, 0, 0, 0] = [1.2, -1.3, 0.0]
    assert (np.abs(grid) > 1).any(axis=-1).mean() > 0.3
    want = np.asarray(JF.warp_volume(jnp.asarray(vol), jnp.asarray(grid)))
    got = TF.warp_volume(t(vol).permute(0, 4, 1, 2, 3), t(grid)).permute(0, 2, 3, 4, 1)
    assert tuple(got.shape) == want.shape == (2, 3, 7, 9, 3)
    close(got, want, atol=1e-5)
