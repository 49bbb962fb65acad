"""The training slice as a whole: the port's ``p_losses_face`` and optimizer against JAX's.

The tiny bundle's params (``tests/conftest.py::tiny_bundle``) are converted
into the port's tiny ``VFaceModel`` on the CPU; both sides see the same batch
and the same ``fixed`` draws, in fp32. The loss's parts are held here too:
the DDIM reconstruction chain and the sampled posterior.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t
from vface_tpu.pipelines import train as JT
from vface_tpu.samplers.ddim import ddim_sample_train as jax_ddim_sample_train
from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.pipelines import train as TT
from vface_torch.samplers.ddim import ddim_sample_train, train_recon_timesteps
from vface_torch.utils.convert import from_flax_params

TCFG = dict(reconstruct=True, reconstruct_steps=2, id_loss_weight=0.3)  # no LPIPS: JAX's perceptual_fn is None


@pytest.fixture(scope="module")
def bundles(tiny_bundle):
    jm, params = tiny_bundle
    tm = VFaceModel(ModelConfig.tiny(image_size=32), device="cpu", conditioner=True)
    tm.load_params(from_flax_params(np_tree(params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def data(bundles):
    jm = bundles[0]
    rng = np.random.default_rng(21)
    b, s = 2, jm.cfg.image_size
    clip, hl = jm.cfg.cond.clip.image_size, jm.cfg.latent_size
    batch = dict(
        gt_image=rng.uniform(-0.9, 0.9, (b, s, s, 3)), inpaint=rng.uniform(-0.9, 0.9, (b, s, s, 3)),
        mask=(rng.uniform(size=(b, s, s, 1)) > 0.3), ref_clip=rng.normal(size=(b, clip, clip, 3)) * 0.3,
        ref_face01=rng.uniform(size=(b, 112, 112, 3)), landmarks=rng.uniform(size=(b, 136)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    fixed = dict(t=np.asarray([37, 815]), noise=rng.normal(size=(b, hl, hl, 4)).astype(np.float32),
                 drop=np.asarray([True, False])[:, None, None],
                 enc_eps0=rng.normal(size=(b, hl, hl, 4)).astype(np.float32),
                 enc_eps1=rng.normal(size=(b, hl, hl, 4)).astype(np.float32))
    return batch, fixed


def _port_grads(tm, name):
    """The port's parameter ``name`` -> (params tree part, state-dict key)."""
    top, key = name.split(".", 1)
    return {"conditioner": "cond"}.get(top, top), key


@pytest.fixture(scope="module")
def losses(bundles, data):
    """JAX's and the port's (loss, logs, grads) on the same batch and draws."""
    jm, params, tm = bundles
    batch, fixed = data
    cfg = JT.TrainConfig(**TCFG)

    def loss_fn(p):
        return JT.p_losses_face(jm, p, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                                cfg, None, {k: jnp.asarray(v) for k, v in fixed.items()})

    (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    mask = TT.trainable_mask(tm)
    tfixed = {k: t(v).long() if k == "t" else t(v) for k, v in fixed.items()}
    tloss, tlogs = TT.p_losses_face(tm, {k: t(v) for k, v in batch.items()}, None, TT.TrainConfig(**TCFG),
                                    tfixed)
    tloss.backward()
    return dict(jloss=jloss, jlogs=jlogs, jgrads=from_flax_params(np_tree(jgrads)), jgrads_tree=jgrads,
                tloss=tloss, tlogs=tlogs, mask=mask)


def test_trainable_mask_is_the_reference_set(bundles, losses):
    jm, params, tm = bundles
    jmask = from_flax_params(np_tree(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), JT.trainable_mask(params), params)))
    mask = losses["mask"]
    assert len(mask) == sum(len(v) for v in jmask.values())
    for name, flag in mask.items():
        part, key = _port_grads(tm, name)
        assert flag == bool(jmask[part][key].all()), name
    trained = {n.split(".")[1] for n, f in mask.items() if f and n.startswith("conditioner")}
    assert trained == {"clip_encoder", "proj_out_source", "proj_out_target", "id_proj_out",
                       "landmark_proj_out", "learnable_vector"}
    assert not any(f for n, f in mask.items() if n.startswith(("vae.", "conditioner.arcface.")))


def test_p_losses_face_matches_jax(losses):
    """Loss and every log within 1e-5 relative."""
    assert set(losses["tlogs"]) == {k for k in losses["jlogs"]} == {"loss", "loss_simple", "loss_id"}
    for key, want in losses["jlogs"].items():
        assert losses["tlogs"][key].item() == pytest.approx(float(want), rel=1e-5), key
    assert losses["tloss"].item() == pytest.approx(float(losses["jloss"]), rel=1e-5)


def test_gradients_match_jax(bundles, losses):
    """Every trainable leaf within 1e-4 of its largest |g|, plus 1e-7 of the
    largest |g| of the whole tree: the fp32 round-off floor where a GroupNorm
    makes a leaf's gradient zero in exact arithmetic (the tiny UNet has one
    channel per group, so the biases in front of its GroupNorms get noise of
    ~3e-8 of the largest gradient on both sides). Frozen leaves get none."""
    tm = bundles[2]
    floor = 1e-7 * max(float(g.abs().max()) for part in losses["jgrads"].values() for g in part.values())
    checked = 0
    for name, p in tm.named_parameters():
        part, key = _port_grads(tm, name)
        want = losses["jgrads"][part][key].numpy()
        if not losses["mask"][name]:
            assert p.grad is None, name
            continue
        if p.grad is None:  # unused by this loss (attn2 q/k under a one-token context): JAX's is zero
            assert not want.any(), name
            continue
        close(p.grad, want, atol=1e-4 * float(np.abs(want).max()) + floor)
        checked += 1
    assert checked > 100
    assert tm.conditioner.learnable_vector.grad.abs().max() > 0  # drop[0] routes the eps loss to it


def test_optimizer_matches_optax_on_the_same_gradients(bundles, losses):
    """Two AdamW steps fed the same gradients (JAX's, then 1.5 times them),
    warm-up 1 and lr 1e-3: the multiplier is f(0) = 1e-6 on the first step and
    f(1) = 1 on the second, as at optax's count 0 and 1. Params within 1e-6
    of each leaf's peak plus 2e-5 of one lr-sized step: optax takes the bias
    correction 1 - 0.999^t in float32, where the cancellation leaves ~1e-5
    relative error at t = 2 (torch takes it in float64), and a leaf that
    starts at 0 moves by ~lr. Frozen leaves stay as they were."""
    jm, params, tm = bundles
    tm = copy.deepcopy(tm)
    cfg = dict(warmup_steps=1, learning_rate=1e-3)
    jopt = JT.make_optimizer(JT.TrainConfig(**cfg), params)
    state = jopt.init(params)
    opt, sched = TT.make_optimizer(TT.TrainConfig(**cfg), tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jparams = params
    for step in range(2):
        grads = jax.tree_util.tree_map(lambda g: g * (1.0 + 0.5 * step), losses["jgrads_tree"])
        updates, state = jopt.update(grads, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        sd = from_flax_params(np_tree(grads))
        for name, p in tm.named_parameters():
            part, key = _port_grads(tm, name)
            p.grad = sd[part][key].clone() if p.requires_grad else None
        opt.step()
        sched.step()
    assert sched.get_last_lr()[0] == pytest.approx(1e-3)
    want = from_flax_params(np_tree(jparams))
    for name, p in tm.named_parameters():
        part, key = _port_grads(tm, name)
        w = want[part][key].numpy()
        if not p.requires_grad:
            assert torch.equal(p.detach(), before[name]), name
        elif losses["jgrads"][part][key].any():
            assert not torch.equal(p.detach(), before[name]), name
        close(p.detach(), w, atol=1e-6 * float(np.abs(w).max()) + 2e-5 * cfg["learning_rate"])


def test_ddim_sample_train_matches_jax(bundles):
    """The 4-step chain's timesteps and its (z, intermediates): [x_T, pred_x0
    at i = 0, pred_x0 at i = 3]."""
    jm, params, tm = bundles
    np.testing.assert_array_equal(train_recon_timesteps(999, 4), [748, 499, 250, 1])
    rng = np.random.default_rng(22)
    b, hl = 2, jm.cfg.latent_size
    z, zin = (rng.normal(size=(b, hl, hl, 4)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(b, hl, hl, 1)).astype(np.float32)
    cond = rng.normal(size=(b, 1, 64)).astype(np.float32)
    wz, winters = jax_ddim_sample_train(jm, params, jnp.asarray(z), 999, 4, jnp.asarray(cond),
                                        jnp.asarray(zin), jnp.asarray(mask))
    with torch.no_grad():
        gz, ginters = ddim_sample_train(tm, t(z), 999, 4, t(cond), t(zin), t(mask))
    assert ginters.shape == (3, b, hl, hl, 4)
    close(gz, wz, atol=1e-5 * float(np.abs(np.asarray(wz)).max()))
    close(ginters, winters, atol=1e-5 * float(np.abs(np.asarray(winters)).max()))


def test_encode_first_stage_given_eps_matches_jax(bundles):
    jm, params, tm = bundles
    rng = np.random.default_rng(23)
    img = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    eps = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = jm.encode_first_stage_given_eps(params, jnp.asarray(img), jnp.asarray(eps))
    with torch.no_grad():
        got = tm.encode_first_stage_given_eps(t(img), t(eps))
    close(got, want, atol=1e-5)
    # the generator-drawn sample: mean + std * a standard normal draw
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with torch.no_grad():
        drawn = tm.encode_first_stage_sample(t(img), g1)
        again = tm.encode_first_stage_given_eps(t(img), torch.randn(2, 16, 16, 4, generator=g2))
    assert torch.equal(drawn, again)


def test_schedule_helpers_match_jax(bundles):
    """vlb_weights (the VLB term's per-t weight) and predict_start_from_noise."""
    jm, _, tm = bundles
    close(TT.vlb_weights(tm), JT.vlb_weights(jm), atol=0.0, rtol=1e-6)
    rng = np.random.default_rng(24)
    z, noise = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.asarray([1, 999])
    want = jm.predict_start_from_noise(jnp.asarray(z), jnp.asarray(ts), jnp.asarray(noise))
    close(tm.predict_start_from_noise(t(z), t(ts).long(), t(noise)), want, atol=1e-5)


def test_make_train_step_updates_only_the_trainable_set(bundles, data):
    """One step: detached logs, the trainable set moved, every frozen parameter
    as it was; the draws come from the generator (no ``fixed``)."""
    tm = copy.deepcopy(bundles[2])
    batch = {k: t(v) for k, v in data[0].items()}
    opt, sched = TT.make_optimizer(TT.TrainConfig(**TCFG, learning_rate=1e-3, warmup_steps=1), tm)
    step = TT.make_train_step(tm, opt, sched, TT.TrainConfig(**TCFG))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    logs = step(batch, torch.Generator().manual_seed(3))
    assert set(logs) == {"loss", "loss_simple", "loss_id"}
    assert all(v.grad_fn is None and torch.isfinite(v) for v in logs.values())
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), before[name]), name
    assert not torch.equal(tm.unet.out_conv.weight.detach(), before["unet.out_conv.weight"])
    assert sched.get_last_lr()[0] == pytest.approx(1e-3)


def test_conditioner_is_built_for_training_only(bundles):
    """Serving's model has no conditioner and ignores a "cond" part; a model
    with one needs it. The UNet and VAE load strictly either way."""
    params = from_flax_params(np_tree(bundles[1]))
    serve = VFaceModel(ModelConfig.tiny(image_size=32), device="cpu")
    serve.load_params(params)
    assert serve.conditioner is None and not any(n.startswith("conditioner.") for n, _ in serve.named_parameters())
    with pytest.raises(ValueError, match="without a conditioner"):
        serve.uncond(1)
    with pytest.raises(KeyError):
        serve.load_params({"unet": params["unet"]})
    with pytest.raises(KeyError):
        VFaceModel(ModelConfig.tiny(image_size=32), device="cpu", conditioner=True).load_params(
            {"unet": params["unet"], "vae": params["vae"]})
    assert torch.equal(serve.unet.out_conv.weight, bundles[2].unet.out_conv.weight)
