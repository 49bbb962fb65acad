"""The port's conditioner, its parts and the training utilities against the JAX package.

fp32 on the CPU at tiny configs: each Flax module is initialised, its params
(perturbed where the init leaves them trivial: biases, frozen-BN statistics)
go through ``flax_tree_to_state_dict`` into the port's module, and both see the
same seeded numpy input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t
from vface_tpu.models import arcface as JArc
from vface_tpu.models import clip as JClip
from vface_tpu.models import conditioning as JCond
from vface_tpu.ops.pooling import adaptive_avg_pool as jax_pool
from vface_tpu.utils.lr_schedules import lambda_linear_schedule as jax_schedule
from vface_torch.models import arcface as TArc
from vface_torch.models import clip as TClip
from vface_torch.models import conditioning as TCond
from vface_torch.models.unet import UNetConfig, UNetModel
from vface_torch.ops.pooling import adaptive_avg_pool
from vface_torch.utils.convert import flax_tree_to_state_dict
from vface_torch.utils.lr_schedules import lambda_linear_schedule


def _perturb(params, seed):
    """Every leaf + 0.05 * normal; frozen-BN variances kept positive."""
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(flat))
    out = []
    for (path, p), key in zip(flat, keys):
        noise = 0.05 * jax.random.normal(key, p.shape, p.dtype)
        name = getattr(path[-1], "key", "")
        out.append(p + (jnp.abs(noise) if name == "var" else noise))
    return jax.tree_util.tree_unflatten(tree, out)


def _load(tmod, params):
    tmod.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    return tmod


def _rel(got, want, tol):
    """|got - want| <= tol * max|want| (fp32 round-off at the output's scale)."""
    want = np.asarray(want, np.float32)
    close(got, want, atol=tol * float(np.abs(want).max()))


def test_clip_conditioner_matches_jax():
    cfg = JClip.CLIPVisionConfig.tiny()
    x = (np.random.default_rng(0).normal(size=(2, 32, 32, 3)) * 0.5).astype(np.float32)
    jmod = JClip.CLIPConditioner(cfg)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _load(TClip.CLIPConditioner(TClip.CLIPVisionConfig.tiny()), params)
    got = tmod(t(x))
    assert got.shape == (2, 1, 64) and got.dtype == torch.float32
    _rel(got.detach(), want, 1e-5)


def test_clip_preprocess_matches_jax():
    """A non-antialiased bilinear resize (64 -> 32 and 20 -> 32), then CLIP's mean/std."""
    for side in (64, 20):
        x = np.random.default_rng(side).uniform(size=(2, side, side, 3)).astype(np.float32)
        close(TClip.clip_preprocess(t(x), 32), JClip.clip_preprocess(jnp.asarray(x), 32), atol=1e-5)


def test_irse50_with_preprocess_matches_jax():
    """arcface_preprocess (adaptive pools 64 -> 256 -> crop -> 112) then a
    two-stage IR-SE net with frozen BN, PReLU and SE; embedding 512."""
    stages = ((16, 1), (32, 1))
    img = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jx = JArc.arcface_preprocess(jnp.asarray(img))
    tx = TArc.arcface_preprocess(t(img))
    close(tx, jx, atol=1e-6)
    jmod = JArc.IRSE50(stages=stages)
    params = _perturb(jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 112, 112, 3)))["params"], 4)
    want = jmod.apply({"params": params}, jx)
    got = _load(TArc.IRSE50(stages=stages), params)(tx)
    _rel(got.detach(), want, 1e-5)
    close(TArc.safe_l2_normalize(got.detach()), JArc.safe_l2_normalize(want), atol=1e-6)


def test_conditioner_and_uncond_match_jax():
    """The "sum" token: CLIP source + target, the ArcFace ID term and the
    landmark term, divided by the summed weights; and the uncond token."""
    rng = np.random.default_rng(5)
    src, tar = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32) * 0.5 for _ in range(2))
    face = rng.uniform(size=(2, 112, 112, 3)).astype(np.float32)
    lm = rng.uniform(size=(2, 136)).astype(np.float32)
    jmod = JCond.Conditioner(JCond.ConditionerConfig.tiny())
    args = [jnp.asarray(a) for a in (src, lm, tar, face)]
    params = _perturb(jmod.init(jax.random.PRNGKey(6), *args)["params"], 7)
    want = jmod.apply({"params": params}, *args)
    tmod = _load(TCond.Conditioner(TCond.ConditionerConfig.tiny()), params)
    got = tmod(t(src), t(lm), t(tar), t(face))
    assert got.shape == (2, 1, 64)
    _rel(got.detach(), want, 1e-5)
    close(tmod.uncond(3).detach(), jmod.apply({"params": params}, 3, method=JCond.Conditioner.uncond), atol=0)
    # without the optional branches: the CLIP source term alone, still over clip + id weights
    _rel(tmod(t(src)).detach(), jmod.apply({"params": params}, args[0]), 1e-5)


@pytest.mark.parametrize("src,dst", [((32, 32), (16, 16)), ((20, 30), (7, 11)), ((8, 6), (16, 9))])
def test_adaptive_avg_pool_matches_jax(src, dst):
    x = np.random.default_rng(8).normal(size=(2, *src, 3)).astype(np.float32)
    close(adaptive_avg_pool(t(x), *dst), jax_pool(jnp.asarray(x), *dst), atol=1e-6)


@pytest.mark.parametrize("warmup", [1, 10_000])
def test_lambda_linear_schedule_matches_jax(warmup):
    mine, theirs = lambda_linear_schedule(warmup), jax_schedule(warmup)
    for n in (0, 1, 2, 7, 9_999, 10_000, 10_001, 10**6):
        assert mine(n) == pytest.approx(float(theirs(n)), rel=1e-6, abs=0.0)


def test_unet_remat_gives_the_same_gradients():
    """use_remat (checkpointed ResBlocks and SpatialTransformers) changes
    memory, not arithmetic: gradients equal to 1e-6 of each leaf's peak; the
    recomputed forwards are counted by a spy on every transformer's forward."""
    from unittest import mock

    from vface_torch.models import unet as unet_mod

    torch.manual_seed(0)
    base = UNetModel(UNetConfig.tiny())
    with torch.no_grad():
        for p in base.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    rng = np.random.default_rng(9)
    x = t(rng.normal(size=(2, 16, 16, 9)).astype(np.float32))
    ts = torch.tensor([3, 700])
    ctx = t(rng.normal(size=(2, 1, 64)).astype(np.float32))
    grads = {}
    calls = {}
    real = unet_mod.SpatialTransformer.forward
    for remat in (False, True):
        net = UNetModel(dataclasses.replace(UNetConfig.tiny(), use_remat=remat))
        net.load_state_dict(base.state_dict())
        count = [0]

        def spy(self, *args, _count=count):
            _count[0] += 1
            return real(self, *args)

        with mock.patch.object(unet_mod.SpatialTransformer, "forward", spy):
            (net(x, ts, ctx) ** 2).mean().backward()
        calls[remat] = count[0]
        # attn2's to_q/to_k get none: a one-token context skips the scores
        grads[remat] = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
    assert calls[True] == 2 * calls[False] > 0  # every checkpointed block runs again in the backward
    assert grads[True].keys() == grads[False].keys() and len(grads[False]) > 100
    for name, g in grads[False].items():
        close(grads[True][name], g.numpy(), atol=1e-6 * float(g.abs().max()) + 1e-12)
