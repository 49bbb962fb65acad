"""Data-parallel training with ZeRO-1 (``make_optimizer(mesh=)``, ``make_train_step(mesh=)``,
``train(n_data=)``) against the one-rank step and the JAX package's ZeRO-1 step.

The tiny bundle (``ModelConfig.tiny(image_size=32)`` with its conditioner,
seeded numpy: no JAX init is compiled), fp32 on the CPU, 2 gloo ranks
(``tests/_torch_dist.py``) with one row each of a global batch of 2, the
reference operating point's loss (the 2-step DDIM reconstruction with the ID
loss; no LPIPS), AdamW at lr 1e-3 with a 1-step warm-up.

* From one generator seed, 2 steps over 2 ranks (fused and split) against
  the one-rank step on the global batch: every rank draws at the global
  batch's shape and takes its rows, and gathers the reference batch for the
  flip. On the same params and ``fixed`` draws the averaged gradients are
  within 1e-5 of each leaf's peak (plus ``test_torch_train.py``'s round-off
  floor, 1e-7 of the tree's peak) of the one-rank gradients on the global
  batch: each rank's kernels run at batch 1 against the one rank's at batch
  2, and round differently (2e-6 of a leaf's peak in this run). After 2
  AdamW steps each leaf's params are within 1e-3 of the one-rank run's
  update in relative L2: AdamW normalises each element, so where a gradient
  cancels across the rows its round-off reaches a share of a step (1.1e-6
  and 2.1e-6 at lr 1e-3 on single elements of 16384 and 4096, which no
  element-wise 1e-6 holds). The leaves whose gradient is round-off alone (under 1e-5 of the
  tree's peak at some step: q and k of the CLIP mapper's attention over one
  token, whose softmax makes them zero in exact arithmetic) take steps of up to the
  learning rate in the noise's direction on either side; they are held to
  2 x lr.
* With JAX's ``fixed`` draws the ranks' averaged gradients are held to JAX's
  on its 2-device mesh (batch sharded, the gradient ``psum`` from the
  shardings) within ``tests/test_torch_train.py``'s gradient limits, and two
  ZeRO-1 steps fed JAX's gradients to optax's AdamW under
  ``zero1_sharding`` within its optimizer limits.
* Each rank holds about half the AdamW moments; the state gathered on rank
  0 is the one-device layout (it loads into a plain AdamW and equals the
  one-rank run's).
* ``train(n_data=2)`` for 2 steps writes one logdir (rank 0), scales the lr
  by the ranks, equals a one-rank ``train`` at that lr, and its ``last``
  loads into a one-rank optimizer.
* When one rank's step raises, every rank exits (none waits out the run's
  time limit) and none enters the collective save of ``last``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import _tiny_model, run_ranks, spawn_ranks
from _torch_port import close, np_tree, seeded_bundle_params, t
from vface_torch.pipelines import train as TT
from vface_torch.runtime.checkpoint import TrainCheckpointer
from vface_torch.utils.convert import from_flax_params

RANKS, B = 2, 2
CFG = dict(reconstruct=True, reconstruct_steps=2, id_loss_weight=0.3, warmup_steps=1, learning_rate=1e-3)
SEED, STEPS = 5, 2


def _part(name):
    top, key = name.split(".", 1)
    return {"conditioner": "cond"}.get(top, top), key


@pytest.fixture(scope="module")
def bundle():
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel

    jm = JModel(JConfig.tiny(image_size=32))
    params = seeded_bundle_params(jm, seed=29)
    rng = np.random.default_rng(30)
    s, clip, hl = jm.cfg.image_size, jm.cfg.cond.clip.image_size, jm.cfg.latent_size
    batch = dict(gt_image=rng.uniform(-0.9, 0.9, (B, s, s, 3)), inpaint=rng.uniform(-0.9, 0.9, (B, s, s, 3)),
                 mask=(rng.uniform(size=(B, s, s, 1)) > 0.3), ref_clip=rng.normal(size=(B, clip, clip, 3)) * 0.3,
                 ref_face01=rng.uniform(size=(B, 112, 112, 3)), landmarks=rng.uniform(size=(B, 136)))
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    fixed = dict(t=np.asarray([37, 815]), noise=rng.normal(size=(B, hl, hl, 4)).astype(np.float32),
                 drop=np.asarray([True, False])[:, None, None],
                 enc_eps0=rng.normal(size=(B, hl, hl, 4)).astype(np.float32),
                 enc_eps1=rng.normal(size=(B, hl, hl, 4)).astype(np.float32))
    return dict(jm=jm, params=params, state=from_flax_params(np_tree(params)), batch=batch, fixed=fixed)


@pytest.fixture(scope="module")
def jax_zero1(bundle):
    """JAX on its 2-device mesh: the gradients of the loss on the fixed draws
    (batch sharded, params replicated) and two optax steps under ZeRO-1."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from vface_tpu.parallel.mesh import make_mesh, zero1_sharding
    from vface_tpu.pipelines import train as JT

    jm, params = bundle["jm"], bundle["params"]
    mesh = make_mesh(n_data=RANKS)
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    cfg = JT.TrainConfig(**{k: v for k, v in CFG.items()})
    fixed = {k: jnp.asarray(v) for k, v in bundle["fixed"].items()}

    def loss_fn(p, batch):
        return JT.p_losses_face(jm, p, batch, jax.random.PRNGKey(0), cfg, None, fixed)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), in_shardings=(repl, shard))
    batch = jax.device_put({k: jnp.asarray(v) for k, v in bundle["batch"].items()}, shard)
    _, grads = grad_fn(jax.device_put(params, repl), batch)
    opt = JT.make_optimizer(cfg, params)
    state = opt.init(params)
    oss = zero1_sharding(mesh, state)
    update = jax.jit(opt.update, out_shardings=(repl, oss))
    p = params
    for scale in (1.0, 1.5):
        updates, state = update(jax.tree_util.tree_map(lambda g: g * scale, grads), jax.device_put(state, oss), p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
    assert any(leaf.sharding.spec != P() for leaf in jax.tree_util.tree_leaves(state) if getattr(leaf, "ndim", 0) >= 2)
    return dict(grads=from_flax_params(np_tree(grads)), params=from_flax_params(np_tree(p)))


@pytest.fixture(scope="module")
def ranks(bundle, jax_zero1, tmp_path_factory):
    feed = {}
    model = _tiny_model(bundle["state"], conditioner=True)
    for name, p in model.named_parameters():
        part, key = _part(name)
        feed[name] = jax_zero1["grads"][part][key]
    variants = dict(fused=dict(split=False, seed=SEED, steps=STEPS), split=dict(split=True, seed=SEED, steps=STEPS),
                    fixed=dict(fixed={k: t(v).long() if k == "t" else t(v) for k, v in bundle["fixed"].items()},
                               feed=feed))
    ins = dict(state=bundle["state"], cfg=CFG, b_local=B // RANKS, variants=variants,
               batch={k: t(v) for k, v in bundle["batch"].items()})
    return run_ranks("train_steps", RANKS, ins, tmp_path_factory.mktemp("ddp"))


def _one_rank(bundle, split: bool):
    """The one-rank run on the global batch; also the leaves whose gradient is
    round-off alone at some step."""
    model = _tiny_model(bundle["state"], conditioner=True)
    cfg = TT.TrainConfig(**CFG)
    opt, sched = TT.make_optimizer(cfg, model)
    step = (TT.make_split_train_step if split else TT.make_train_step)(model, opt, sched, cfg)
    gen = torch.Generator().manual_seed(SEED)
    batch = {k: t(v) for k, v in bundle["batch"].items()}
    logs, noise = [], set()
    for _ in range(STEPS):
        logs.append(step(batch, gen))
        peaks = {n: float(p.grad.abs().max()) for n, p in model.named_parameters() if p.grad is not None}
        noise |= {n for n, g in peaks.items() if g < 1e-5 * max(peaks.values())}
    return model, opt, logs, noise


def _same_update(got: dict, one, init: dict, noise: set, lr: float) -> None:
    """Each leaf of ``got`` against the one-rank model ``one``: within 1e-3 of
    the one-rank update (``one`` - ``init``) in relative L2, a round-off leaf
    within 2 x lr of it element-wise, a leaf that did not move equal."""
    assert len(noise) < 0.1 * sum(p.requires_grad for p in one.parameters()), sorted(noise)
    for name, p in one.named_parameters():
        want, start = p.detach(), init[name]
        if name in noise:
            close(got[name], want.numpy(), atol=2 * lr)
        elif torch.equal(want, start):
            assert torch.equal(got[name], want), name
        else:
            err = float((got[name] - want).norm() / (want - start).norm())
            assert err <= 1e-3, (name, err)


@pytest.mark.parametrize("variant", ["fused", "split"])
def test_two_ranks_equal_one_rank_on_the_global_batch(bundle, ranks, variant):
    model, opt, logs, noise = _one_rank(bundle, variant == "split")
    init = {k: v.detach() for k, v in _tiny_model(bundle["state"], conditioner=True).named_parameters()}
    for r in range(RANKS):
        _same_update(ranks[r][variant]["params"], model, init, noise, CFG["learning_rate"])
    moved = [n for n, p in model.named_parameters() if p.requires_grad and not torch.equal(p.detach(), init[n])]
    assert len(moved) > 100
    # the ranks' logs average to the one-rank logs of the global batch
    for i in range(STEPS):
        mean = np.mean([ranks[r][variant]["logs"][i]["loss"] for r in range(RANKS)])
        assert mean == pytest.approx(float(logs[i]["loss"]), rel=1e-5)


def test_averaged_gradients_equal_the_one_rank_gradients(bundle, ranks):
    model = _tiny_model(bundle["state"], conditioner=True)
    TT.trainable_mask(model)
    fixed = {k: t(v).long() if k == "t" else t(v) for k, v in bundle["fixed"].items()}
    loss, _ = TT.p_losses_face(model, {k: t(v) for k, v in bundle["batch"].items()}, None, TT.TrainConfig(**CFG),
                               fixed)
    loss.backward()
    floor = 1e-7 * max(float(p.grad.abs().max()) for p in model.parameters() if p.grad is not None)
    got = ranks[0]["fixed"]["grads"]
    assert set(got) == {n for n, p in model.named_parameters() if p.grad is not None}
    for name, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.numpy()
            close(got[name], g, atol=1e-5 * float(np.abs(g).max()) + floor)


def test_averaged_gradients_and_zero1_steps_match_jax(bundle, jax_zero1, ranks):
    """The gradient limits of ``test_torch_train.py::test_gradients_match_jax``
    and the optimizer limits of its ``test_optimizer_matches_optax_on_the_same_gradients``."""
    jg = jax_zero1["grads"]
    floor = 1e-7 * max(float(g.abs().max()) for part in jg.values() for g in part.values())
    checked = 0
    model = _tiny_model(bundle["state"], conditioner=True)
    mask = TT.trainable_mask(model)
    for name in mask:
        part, key = _part(name)
        want = jg[part][key].numpy()
        got = ranks[0]["fixed"]["grads"].get(name)
        if not mask[name]:
            assert got is None, name
            continue
        if got is None:  # unused by this loss: JAX's is zero
            assert not want.any(), name
            continue
        close(got, want, atol=1e-4 * float(np.abs(want).max()) + floor)
        close(ranks[1]["fixed"]["grads"][name], got.numpy(), atol=0.0)
        checked += 1
    assert checked > 100
    for name, trainable in mask.items():
        part, key = _part(name)
        w = jax_zero1["params"][part][key].numpy()
        for r in range(RANKS):
            close(ranks[r]["fixed"]["params"][name], w, atol=1e-6 * float(np.abs(w).max()) + 2e-5 * CFG["learning_rate"])


def test_moments_are_sharded_and_gather_to_the_one_device_layout(bundle, ranks):
    model, opt, _, _ = _one_rank(bundle, False)
    total = sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
                if isinstance(v, torch.Tensor) and v.ndim > 0)
    per_rank = [ranks[r]["fused"]["state_bytes"] for r in range(RANKS)]
    assert sum(per_rank) == total
    assert all(0.3 * total <= b <= 0.7 * total for b in per_rank), (per_rank, total)
    gathered = ranks[0]["fused"]["opt_state"]
    assert ranks[1]["fused"]["opt_state"] is None
    fresh, _ = TT.make_optimizer(TT.TrainConfig(**CFG), _tiny_model(bundle["state"], conditioner=True))
    fresh.load_state_dict(gathered)
    want = opt.state_dict()["state"]
    assert set(gathered["state"]) == set(want)
    for k in ("exp_avg", "exp_avg_sq"):  # the gradients' limits, carried into the moments
        top = max(float(st[k].abs().max()) for st in want.values())
        for i, st in want.items():
            close(gathered["state"][i][k], st[k].numpy(), atol=1e-4 * float(st[k].abs().max()) + 1e-6 * top)


def test_train_over_two_ranks_writes_one_logdir(bundle, tmp_path):
    from vface_torch.models.ldm import ModelConfig
    from vface_torch.pipelines.train import TrainConfig
    from vface_torch.pipelines.train_driver import DriverConfig, train

    logdir = str(tmp_path / "logs")
    driver = dict(logdir=logdir, max_steps=2, log_every=1, image_log_every=2, ckpt_every=2, batch_size=1,
                  scale_lr=True, seed=SEED)
    batches = [bundle["batch"]] * 3
    ins = dict(cfg=CFG, driver=driver, batches=batches, init=bundle["state"])
    os.makedirs(tmp_path / "ranks")
    outs = run_ranks("train_driver", RANKS, ins, tmp_path / "ranks")
    # --scale_lr counts the ranks: base x 2 ranks x bs 1
    assert outs[0]["lr"] == outs[1]["lr"] == [CFG["learning_rate"] * RANKS]
    one = train(ModelConfig.tiny(image_size=32), TrainConfig(**{**CFG, "learning_rate": CFG["learning_rate"] * 2}),
                DriverConfig(**{**driver, "logdir": str(tmp_path / "one"), "scale_lr": False}), iter(batches),
                init_params=bundle["state"], device="cpu")
    init = {k: v.detach() for k, v in _tiny_model(bundle["state"], conditioner=True).named_parameters()}
    noise = _one_rank(bundle, False)[3]  # the same draws: the seed's generator, the same batch
    for o in outs:
        _same_update(o["params"], one, init, noise, CFG["learning_rate"] * RANKS)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert sorted(os.listdir(os.path.join(logdir, "images"))) == ["rec_00000002.png"]
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints"))) == sorted(
        os.listdir(os.path.join(str(tmp_path / "one"), "checkpoints")))
    last = TrainCheckpointer(os.path.join(logdir, "checkpoints")).restore_last()
    assert last["step"] == 2
    fresh, _ = TT.make_optimizer(TT.TrainConfig(**CFG), _tiny_model(bundle["state"], conditioner=True))
    fresh.load_state_dict(last["state"]["opt_state"])  # the one-device layout


def test_a_failing_rank_ends_the_run_without_a_save(bundle, tmp_path):
    logdir = str(tmp_path / "logs")
    driver = dict(logdir=logdir, max_steps=3, log_every=1, image_log_every=10, ckpt_every=10, batch_size=1, seed=SEED)
    ins = dict(cfg=CFG, driver=driver, batches=[bundle["batch"]] * 4, init=bundle["state"])
    os.makedirs(tmp_path / "ranks")
    codes, errs = spawn_ranks("train_driver_rank_fails", RANKS, ins, tmp_path / "ranks", timeout=120)
    assert all(c not in (0, None, -9) for c in codes), codes  # every rank failed, and none was killed
    assert "injected failure on the last rank" in errs[RANKS - 1]
    assert 0 in errs  # rank 0's collective failed with its peer gone
    assert not os.path.exists(os.path.join(logdir, "checkpoints", "last"))
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1]
