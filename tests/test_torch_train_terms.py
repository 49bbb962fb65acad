"""The training loss's remaining terms against JAX's, and the split train step.

One tiny bundle at 128^2 (the tiny UNet and conditioner, a three-level tiny
VAE, so the latent is 32^2): LPIPS's AlexNet needs 128^2 for its third scale
(32^2 after two halvings, above the two VALID 3x3/2 max-pools). Its params
are seeded numpy (``tests/_torch_port.py::seeded_bundle_params``), with a
seeded ``landmark_head`` and seeded LPIPS weights, converted into the port's
model on the CPU. Both sides see the same batch and the same ``fixed`` draws,
in fp32, with every term on: epsilon MSE, VLB, the landmark head, the DDIM
reconstruction's ID loss and LPIPS. One JAX ``value_and_grad`` is compiled.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import np_tree, seeded_bundle_params, seeded_flax_params, seeded_tree, t
from vface_tpu.eval.lpips import LPIPS as JLPIPS, make_lpips_fn as jax_lpips_fn
from vface_tpu.models import ModelConfig as JConfig, VFaceModel as JModel
from vface_tpu.models.conditioning import ConditionerConfig as JCond
from vface_tpu.models.unet import UNetConfig as JUNet
from vface_tpu.models.vae import VAEConfig as JVAE
from vface_tpu.pipelines import train as JT
from vface_tpu.preprocess.landmarks import UNetLandmarkHead as JHead
from vface_torch.eval.lpips import make_lpips_fn
from vface_torch.models.conditioning import ConditionerConfig
from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.models.unet import UNetConfig
from vface_torch.models.vae import VAEConfig
from vface_torch.pipelines import train as TT
from vface_torch.utils.convert import flax_tree_to_state_dict, from_flax_params

S = 128
TERMS = dict(reconstruct=True, reconstruct_steps=1, id_loss_weight=0.3, lpips_loss_weight=0.1,
             landmark_loss_weight=0.1, original_elbo_weight=1e-3)


@pytest.fixture(scope="module")
def bundles():
    jcfg = JConfig(unet=JUNet.tiny(), vae=JVAE(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1), cond=JCond.tiny(),
                   image_size=S)
    jm = JModel(jcfg)
    params = dict(seeded_bundle_params(jm, seed=31))
    hl, mc = jcfg.latent_size, jcfg.unet.model_channels
    params["landmark_head"] = seeded_flax_params(JHead(), jnp.zeros((1, hl, hl, 2 * mc)), seed=32)
    x = jnp.zeros((1, 64, 64, 3))
    lp = seeded_tree(jax.eval_shape(lambda r: JLPIPS().init(r, x, x)["params"], jax.random.PRNGKey(0)), 33)
    cfg = ModelConfig(unet=UNetConfig.tiny(), vae=VAEConfig(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1),
                      cond=ConditionerConfig.tiny(), image_size=S)
    tm = VFaceModel(cfg, device="cpu", conditioner=True, landmark_head=True)
    tm.load_params(from_flax_params(np_tree(params)))
    return dict(jm=jm, params=params, lpips=lp, tm=tm, tlpips=make_lpips_fn(flax_tree_to_state_dict(np_tree(lp)), device="cpu"))


@pytest.fixture(scope="module")
def data(bundles):
    jm = bundles["jm"]
    rng = np.random.default_rng(41)
    b, clip, hl = 2, jm.cfg.cond.clip.image_size, jm.cfg.latent_size
    batch = dict(
        gt_image=rng.uniform(-0.9, 0.9, (b, S, S, 3)), inpaint=rng.uniform(-0.9, 0.9, (b, S, S, 3)),
        mask=(rng.uniform(size=(b, S, S, 1)) > 0.3), ref_clip=rng.normal(size=(b, clip, clip, 3)) * 0.3,
        ref_face01=rng.uniform(size=(b, 112, 112, 3)), landmarks=rng.uniform(size=(b, 136)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    fixed = dict(t=np.asarray([211, 904]), noise=rng.normal(size=(b, hl, hl, 4)).astype(np.float32),
                 drop=np.asarray([False, True])[:, None, None],
                 enc_eps0=rng.normal(size=(b, hl, hl, 4)).astype(np.float32),
                 enc_eps1=rng.normal(size=(b, hl, hl, 4)).astype(np.float32))
    return batch, fixed


def _port_batch(batch, fixed):
    return ({k: t(v) for k, v in batch.items()},
            {k: t(v).long() if k == "t" else t(v) for k, v in fixed.items()})


@pytest.fixture(scope="module")
def losses(bundles, data):
    """JAX's and the port's (loss, logs, grads) with every term on."""
    jm, params, tm = bundles["jm"], bundles["params"], bundles["tm"]
    batch, fixed = data
    cfg = JT.TrainConfig(**TERMS)
    pfn = jax_lpips_fn(bundles["lpips"])

    def loss_fn(p):
        return JT.p_losses_face(jm, p, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                                cfg, pfn, {k: jnp.asarray(v) for k, v in fixed.items()})

    (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    mask = TT.trainable_mask(tm)
    tm.zero_grad(set_to_none=True)
    tb, tf = _port_batch(batch, fixed)
    tloss, tlogs = TT.p_losses_face(tm, tb, None, TT.TrainConfig(**TERMS), tf, perceptual_fn=bundles["tlpips"])
    tloss.backward()
    grads = {n: p.grad.detach().clone() for n, p in tm.named_parameters() if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    return dict(jloss=jloss, jlogs=jlogs, jgrads=from_flax_params(np_tree(jgrads)), tloss=tloss, tlogs=tlogs,
                mask=mask, grads=grads)


def _part_key(name):
    top, key = name.split(".", 1)
    return {"conditioner": "cond"}.get(top, top), key


def test_every_term_matches_jax(losses):
    """The loss and every log (simple, VLB, landmark, ID, LPIPS) within 1e-5 relative."""
    want = {"loss", "loss_simple", "loss_vlb", "loss_landmark", "loss_id", "loss_lpips"}
    assert set(losses["tlogs"]) == set(losses["jlogs"]) == want
    for key, val in losses["jlogs"].items():
        assert losses["tlogs"][key].item() == pytest.approx(float(val), rel=1e-5), key
    assert losses["tloss"].item() == pytest.approx(float(losses["jloss"]), rel=1e-5)


def test_gradients_with_every_term_match_jax(bundles, losses):
    """Every trainable leaf's gradient within 1e-5 of its largest |g| plus 1e-7
    of the tree's largest |g|; the landmark head's leaves included; frozen
    leaves get none. A leaf that a GroupNorm makes zero in exact arithmetic (a
    bias in front of the tiny UNet's one-channel groups) holds fp32 round-off
    on both sides: where JAX's largest |g| there is under 1e-6 of the tree's,
    the port's must be too."""
    tm = bundles["tm"]
    jg = losses["jgrads"]
    top = max(float(np.abs(g.numpy()).max()) for part in jg.values() for g in part.values())
    floor = 1e-7 * top
    head = noise = 0
    bad = []
    for name, _ in tm.named_parameters():
        part, key = _part_key(name)
        want = jg[part][key].numpy()
        got = losses["grads"].get(name)
        if not losses["mask"][name]:
            assert got is None, name
            continue
        if got is None:
            assert not want.any(), name
            continue
        head += part == "landmark_head"
        if float(np.abs(want).max()) <= 1e-6 * top:
            noise += 1
            if float(got.abs().max()) > 1e-6 * top:
                bad.append((name, float(got.abs().max()) / top))
            continue
        err = float(np.abs(got.numpy() - want).max())
        if err > 1e-5 * float(np.abs(want).max()) + floor:
            bad.append((name, err / float(np.abs(want).max())))
    assert not bad, bad
    assert head == 4  # conv and fc, weight and bias
    assert noise < 40, noise


def test_partial_unet_mask_matches_jax(bundles):
    """partial_unet: the UNet's attn2 and norm2 parameters only (by state-dict
    names that mirror the Flax paths), the rest of the set as without it."""
    tm, params = bundles["tm"], bundles["params"]
    for partial in (False, True):
        jmask = from_flax_params(np_tree(jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, m, np.float32), JT.trainable_mask(params, partial), params)))
        mask = TT.trainable_mask(tm, partial_unet=partial)
        assert len(mask) == sum(len(v) for v in jmask.values())
        for name, flag in mask.items():
            part, key = _part_key(name)
            assert flag == bool(jmask[part][key].all()), name
            assert dict(tm.named_parameters())[name].requires_grad == flag
    unet = [n for n, f in mask.items() if f and n.startswith("unet.")]
    assert unet and all(".attn2." in n or ".norm2." in n for n in unet)
    TT.trainable_mask(tm)


def _step_grads(model, step, batch):
    gen = torch.Generator().manual_seed(5)
    logs = step(batch, gen)
    return logs, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}, gen.get_state()


def test_split_step_equals_the_fused_step(bundles, data):
    """make_split_train_step against make_train_step from the same generator
    state: the same draws (the generator ends in the same state), the summed
    gradients of the eps and recon parts within 1e-6 of each leaf's largest
    |g| (plus 1e-8 of the largest), the logs within 1e-6, the params after the
    step within 1e-6."""
    batch = {k: t(v) for k, v in data[0].items()}
    cfg = TT.TrainConfig(**TERMS)
    out = []
    for make in (TT.make_train_step, TT.make_split_train_step):
        m = copy.deepcopy(bundles["tm"])
        opt, sched = TT.make_optimizer(cfg, m)
        out.append((m,) + _step_grads(m, make(m, opt, sched, cfg, bundles["tlpips"]), batch))
    (mf, lf, gf, sf), (ms, ls, gs, ss) = out
    assert torch.equal(sf, ss)
    assert set(lf) == set(ls) and "loss_lpips" in ls and "loss_landmark" in ls
    for k in lf:
        assert ls[k].item() == pytest.approx(lf[k].item(), rel=1e-6), k
    assert gf.keys() == gs.keys()
    top = max(float(g.abs().max()) for g in gf.values())
    for n in gf:
        assert float((gs[n] - gf[n]).abs().max()) <= 1e-6 * float(gf[n].abs().max()) + 1e-8 * top, n
    for (n, a), b in zip(mf.named_parameters(), ms.parameters()):
        assert float((a - b).abs().max()) <= 1e-6 * (float(a.abs().max()) + 1e-30), n


def test_parts_split_the_terms(bundles, data):
    """loss_parts "eps" computes the epsilon, VLB and landmark terms, "recon"
    the ID and LPIPS terms; each makes the fused loss's five draws."""
    tm = bundles["tm"]
    batch = {k: t(v) for k, v in data[0].items()}
    seen = {}
    for part in ("eps", "recon", "all"):
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            _, logs = TT.p_losses_face(tm, batch, gen, TT.TrainConfig(**TERMS, loss_parts=part),
                                       perceptual_fn=bundles["tlpips"])
        seen[part] = (set(logs), gen.get_state())
    assert seen["eps"][0] == {"loss", "loss_simple", "loss_vlb", "loss_landmark"}
    assert seen["recon"][0] == {"loss", "loss_id", "loss_lpips"}
    assert torch.equal(seen["eps"][1], seen["all"][1]) and torch.equal(seen["recon"][1], seen["all"][1])


def test_train_step_with_perceptual_fn(bundles, data):
    """make_train_step with an LPIPS perceptual_fn: the step's logs are the
    loss's (1e-6) from the same generator, LPIPS's weights stay frozen (no
    gradient), and the trainable params move."""
    m = copy.deepcopy(bundles["tm"])
    batch = {k: t(v) for k, v in data[0].items()}
    cfg = dataclasses.replace(TT.TrainConfig(**TERMS), learning_rate=1e-2, warmup_steps=1)
    opt, sched = TT.make_optimizer(cfg, m)
    with torch.no_grad():
        _, want = TT.p_losses_face(m, batch, torch.Generator().manual_seed(3), cfg, perceptual_fn=bundles["tlpips"])
    before = m.unet.out_conv.weight.detach().clone()
    logs = TT.make_train_step(m, opt, sched, cfg, bundles["tlpips"])(batch, torch.Generator().manual_seed(3))
    assert logs["loss_lpips"].item() == pytest.approx(want["loss_lpips"].item(), rel=1e-6)
    assert logs["loss"].item() == pytest.approx(want["loss"].item(), rel=1e-6)
    assert all(p.grad is None for p in bundles["tlpips"].parameters())
    assert not torch.equal(before, m.unet.out_conv.weight)
