"""The port's DIFT priors against the JAX package's ``preprocess/dift.py``.

``ModelConfig.tiny(image_size=32)`` (latent 16 x 16) on seeded numpy weights,
fp32 on the CPU. JAX draws the latent noise from ``PRNGKey(0)``; the port
takes that draw as its ``noise``. The features are held at 1e-4; the cosine
similarity matrices at 1e-5 and the argmax correspondences where the best
and second-best similarity differ by more than that; the prior bit for bit
given equal correspondences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import close, port_model, seeded_bundle_params, smooth_frames, t
from vface_torch.preprocess import dift as TD

S = 32


@pytest.fixture(scope="module")
def setup():
    from vface_tpu.models import ModelConfig, VFaceModel

    jm = VFaceModel(ModelConfig.tiny(image_size=S))
    params = seeded_bundle_params(jm, seed=21)
    model = port_model(params, image_size=S)
    imgs = smooth_frames(2, S, S, seed=22) * 2 - 1
    cond = np.random.default_rng(23).normal(size=(2, 1, jm.cfg.unet.context_dim)).astype(np.float32)
    hl = jm.cfg.latent_size
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, hl, hl, 4)))
    return jm, params, model, imgs, cond, noise


@pytest.mark.parametrize("block", [-4, -1])
def test_dift_features_match_jax(setup, block):
    from vface_tpu.preprocess.dift import dift_features

    jm, params, model, imgs, cond, noise = setup
    want = np.asarray(dift_features(jm, params, jnp.asarray(imgs), jnp.asarray(cond), block=block))
    got = TD.dift_features(model, t(imgs), t(cond), block=block, noise=t(noise))
    assert tuple(got.shape) == want.shape
    close(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_correspondences_and_prior_match_jax(setup):
    from vface_tpu.preprocess import dift as JD

    jm, params, model, imgs, cond, noise = setup
    feats = np.asarray(JD.dift_features(jm, params, jnp.asarray(imgs), jnp.asarray(cond), block=-1))
    ft, fs = feats[0], feats[1]
    c = ft.shape[-1]
    a = ft.reshape(-1, c) / (np.linalg.norm(ft.reshape(-1, c), axis=-1, keepdims=True) + 1e-8)
    b = fs.reshape(-1, c) / (np.linalg.norm(fs.reshape(-1, c), axis=-1, keepdims=True) + 1e-8)
    want_sim = np.asarray(jnp.asarray(a) @ jnp.asarray(b).T)
    close(TD.similarity(t(ft), t(fs)), want_sim, atol=1e-5)
    want = np.asarray(JD.correspondences(jnp.asarray(ft), jnp.asarray(fs)))
    got = TD.correspondences(t(ft), t(fs)).numpy()
    hf = ft.shape[0]
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == (hf, hf, 2)
    srt = np.sort(want_sim.astype(np.float64), axis=1)
    clear = (srt[:, -1] - srt[:, -2] > 1e-5).reshape(hf, hf)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    # the whole prior: JAX's make_prior draws PRNGKey(0) itself
    jprior = np.asarray(JD.make_prior(jm, params, jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(cond),
                                      block=-1))
    prior = TD.make_prior(model, t(imgs[0]), t(imgs[1]), t(cond), block=-1, noise=t(noise))
    assert tuple(prior.shape) == (S, S, 3)
    jcorr = np.asarray(JD.correspondences(jnp.asarray(ft), jnp.asarray(fs)))
    pf = TD.dift_features(model, t(imgs), t(cond), block=-1, noise=t(noise))
    port_corr = TD.correspondences(pf[0], pf[1])
    np.testing.assert_array_equal(port_corr.numpy(), jcorr)  # equal here, so the prior is equal bit for bit
    np.testing.assert_array_equal(prior.numpy(), jprior)


def test_prior_upsamples_with_jax_nearest_rule():
    """At a scale that is not an integer (feature grid 6 onto 32 pixels) the
    pixel correspondences follow JAX's half-pixel nearest resize (``make_prior``'s)."""
    r = np.random.default_rng(3)
    corr = r.integers(0, 6, size=(6, 6, 2)).astype(np.int32)
    src = r.uniform(-1, 1, size=(S, S, 3)).astype(np.float32)
    s = S
    corr_px = jax.image.resize(jnp.asarray(corr).astype(jnp.float32), (s, s, 2), method="nearest") * (s // 6)
    xi = jnp.clip(corr_px[..., 0].astype(jnp.int32), 0, s - 1)
    yi = jnp.clip(corr_px[..., 1].astype(jnp.int32), 0, s - 1)
    want = np.asarray(jnp.asarray(src)[yi, xi])
    np.testing.assert_array_equal(TD.prior_from_correspondences(t(src), t(corr)).numpy(), want)
