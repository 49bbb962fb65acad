"""The training path's data, nets and utilities against the JAX package's.

A 64^2 CelebAMask-HQ-layout directory written by the port's
``write_synthetic_celeba`` feeds both ``CelebATrainDataset``s from one seed;
LPIPS, ``UNetLandmarkHead``, ``return_features``, the VAE's KL and losses
run on seeded params converted from Flax; EMA, the cosine schedule, the
metrics log and the checkpointer's pruning run on both sides. Every JAX call
here is eager (no train step is compiled). Tolerances are in each test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_flax_params, t
from vface_tpu.data import datasets as JD
from vface_tpu.eval.lpips import LPIPS as JLPIPS
from vface_tpu.models.unet import UNetConfig as JUNet, UNetModel as JUNetModel
from vface_tpu.models.vae import AutoencoderKL as JVAE, DiagonalGaussian as JGauss, VAEConfig as JVAEConfig
from vface_tpu.pipelines import vae_train as JV
from vface_tpu.preprocess.landmarks import UNetLandmarkHead as JHead
from vface_tpu.preprocess.tps import tps_warp as jax_tps_warp
from vface_tpu.runtime.checkpoint import TrainCheckpointer as JCkpt, save_params_npz as jax_save_params_npz
from vface_tpu.utils import ema as JE
from vface_tpu.utils.logging import MetricsLogger as JLogger
from vface_tpu.utils.lr_schedules import lambda_warmup_cosine_schedule as jax_cosine
from vface_torch.data import datasets as TD
from vface_torch.eval.lpips import LPIPS
from vface_torch.models.unet import UNetConfig, UNetModel
from vface_torch.models.vae import AutoencoderKL, DiagonalGaussian, VAEConfig
from vface_torch.pipelines import vae_train as TV
from vface_torch.preprocess.landmarks import UNetLandmarkHead
from vface_torch.preprocess.tps import tps_warp
from vface_torch.runtime.checkpoint import TrainCheckpointer, load_params_npz
from vface_torch.utils import ema as TE
from vface_torch.utils.convert import flax_tree_to_state_dict
from vface_torch.utils.logging import MetricsLogger
from vface_torch.utils.lr_schedules import lambda_warmup_cosine_schedule


@pytest.fixture(scope="module")
def celeba(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("celeba"))
    TD.write_synthetic_celeba(root, 5, size=64, seed=3)
    return root


# The TPS maps pixels to within 1e-6 of JAX's in normalised [-1, 1] coordinates
# (fp32: the basis r^2 log r^2 takes XLA's log on one side and the C library's
# on the other, an ulp apart). Sampled on an S-pixel grid that is 1e-6 * (S-1)/2
# pixels, which moves a bilinear sample by at most that times the image's
# largest step between neighbouring pixels (1 for a mask's edge).
COORD_TOL = 1e-6


def _warp_tol(img: np.ndarray) -> float:
    h, w = img.shape[-3:-1]
    step = max(np.abs(np.diff(img, axis=-2)).max(), np.abs(np.diff(img, axis=-3)).max())
    return COORD_TOL * (max(h, w) - 1) / 2 * float(step)


def test_celeba_batches_match_jax(celeba):
    """The same seed gives JAX's batches: the order, the decow's TPS warp of the
    mask, the reference's flip / rotate / blur / elastic draws, over two epochs
    of batch 2. gt_image and ref_image01 within 1e-6; the warped mask and the
    inpaint image (gt x mask) within the TPS's coordinate tolerance carried
    through the warp: 1e-6 * (64 - 1) / 2 (a mask step is at most 1, |gt| <= 1)."""
    jds = JD.CelebATrainDataset(celeba, image_size=64, seed=11)
    tds = TD.CelebATrainDataset(celeba, image_size=64, seed=11)
    assert tds.ids == jds.ids == [0, 1, 2, 3, 4]
    n = 0
    for _ in range(2):
        for jb, tb in zip(jds.batches(2), tds.batches(2)):
            assert jb.keys() == tb.keys() == {"gt_image", "inpaint", "mask", "ref_image01"}
            for k in jb:
                assert tb[k].dtype == np.float32 and tb[k].shape == jb[k].shape, k
                tol = COORD_TOL * (64 - 1) / 2 if k in ("mask", "inpaint") else 1e-6
                np.testing.assert_allclose(tb[k], jb[k], atol=tol, rtol=0, err_msg=k)
            n += 1
    assert n == 4
    mask = tb["mask"]
    assert 0.0 < mask.mean() < 1.0 and ((mask > 0) & (mask < 1)).any()  # a continuous warped mask
    assert len(TD.CelebATrainDataset(celeba, split="val")) == 0


def test_tps_warp_matches_jax():
    """On jittered control points: the TPS's map of every pixel within
    COORD_TOL of JAX's, and tps_warp of a seeded image within that tolerance
    carried through the bilinear sample (:func:`_warp_tol`)."""
    from vface_tpu.preprocess.tps import tps_coefficients as jcoef, tps_transform as jtrans
    from vface_torch.preprocess.tps import tps_coefficients, tps_transform

    rng = np.random.default_rng(5)
    img = rng.uniform(size=(2, 24, 40, 3)).astype(np.float32)
    xs = np.linspace(-1, 1, 3, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(1, 9, 2).repeat(2, 0)
    dst = (grid + rng.uniform(-0.2, 0.2, grid.shape)).astype(np.float32)
    pts = rng.uniform(-1, 1, (2, 500, 2)).astype(np.float32)
    jw, ja = jcoef(jnp.asarray(dst), jnp.asarray(grid))
    w, a = tps_coefficients(t(dst), t(grid))
    close(tps_transform(t(pts), t(dst), w, a), np.asarray(jtrans(jnp.asarray(pts), jnp.asarray(dst), jw, ja)),
          atol=COORD_TOL)
    want = np.asarray(jax_tps_warp(jnp.asarray(img), jnp.asarray(dst), jnp.asarray(grid)))
    close(tps_warp(t(img), t(dst), t(grid)), want, atol=_warp_tol(img))


def test_video_frames_and_augmentations_match_jax(celeba, tmp_path):
    """VideoFramesDataset (frames and parse maps) equal JAX's; _box_blur at
    each kernel size and _elastic_transform from one seed within 1e-6."""
    from PIL import Image

    frames, masks = tmp_path / "frames", tmp_path / "masks"
    frames.mkdir(), masks.mkdir()
    for i in range(5):
        Image.open(os.path.join(celeba, "CelebA-HQ-img", f"{i}.jpg")).save(frames / f"{i}.png")
        Image.open(os.path.join(celeba, "Overall_mask", f"{i}.png")).save(masks / f"{i}.png")
    jv = list(JD.VideoFramesDataset(str(frames), str(masks), image_size=48, window=3))
    tv = list(TD.VideoFramesDataset(str(frames), str(masks), image_size=48, window=3))
    assert len(tv) == len(jv) == 2
    for a, b in zip(jv, tv):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    img = np.asarray(Image.open(frames / "0.png"), np.float32) / 255.0
    for k in (1, 3, 5, 7):
        np.testing.assert_allclose(TD._box_blur(img, k), JD._box_blur(img, k), atol=1e-6, rtol=0)
    got = TD._elastic_transform(img, np.random.default_rng(2))
    np.testing.assert_allclose(got, JD._elastic_transform(img, np.random.default_rng(2)), atol=1e-6, rtol=0)


def test_lpips_matches_jax():
    """LPIPS at 64^2 on seeded weights (every tap's head, the scaling layer,
    the unit normalisation): within 1e-5 relative."""
    rng = np.random.default_rng(7)
    a, b = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    params = seeded_flax_params(JLPIPS(), jnp.asarray(a), jnp.asarray(b), seed=8)
    want = np.asarray(JLPIPS().apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    net = LPIPS()
    net.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    with torch.no_grad():
        got = net(t(a), t(b))
    assert got.shape == (2,)
    close(got, want, atol=0, rtol=1e-5)


def test_landmark_head_and_unet_features_match_jax():
    """UNetLandmarkHead (conv, ReLU, 2x2 max-pool, NCHW flatten, dense) within
    1e-5; the tiny UNet's output-block activations (return_features), in JAX's
    order and layout, within 1e-5 of each one's peak, beside the same epsilon."""
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    hp = seeded_flax_params(JHead(), jnp.asarray(feat), seed=10)
    want = np.asarray(JHead().apply({"params": hp}, jnp.asarray(feat)))
    head = UNetLandmarkHead(64, 16)
    head.load_state_dict(flax_tree_to_state_dict(np_tree(hp)))
    with torch.no_grad():
        close(head(t(feat)), want, atol=1e-5 * np.abs(want).max())

    jcfg, cfg = JUNet.tiny(), UNetConfig.tiny()
    x = rng.normal(size=(2, 16, 16, 9)).astype(np.float32)
    ts = np.asarray([10, 700])
    ctx = rng.normal(size=(2, 1, jcfg.context_dim)).astype(np.float32)
    params = seeded_flax_params(JUNetModel(jcfg), jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), seed=12)
    jeps, jfeats = JUNetModel(jcfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                          return_features=True)
    net = UNetModel(cfg)
    net.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    with torch.no_grad():
        eps, feats = net(t(x), t(ts), t(ctx), return_features=True)
        eps2, feats2, cache = net(t(x), t(ts), t(ctx), return_features=True, return_encoder_cache=True)
    close(eps, np.asarray(jeps), atol=1e-5 * float(jnp.abs(jeps).max()))
    assert len(feats) == len(jfeats) == (cfg.num_res_blocks + 1) * len(cfg.channel_mult)
    for got, w in zip(feats, jfeats):
        assert tuple(got.shape) == w.shape
        close(got, np.asarray(w), atol=1e-5 * float(jnp.abs(w).max()))
    assert torch.equal(eps2, eps) and all(torch.equal(a, b) for a, b in zip(feats2, feats)) and len(cache) == 2


def test_ema_and_cosine_schedule_match_jax():
    """EMA over 3 updates (the warm-up decay) within 1e-7; the cosine schedule
    at its edge steps (0, the warm-up's end, mid-cycle, the cycle's end and past it) within 1e-7."""
    rng = np.random.default_rng(13)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    js = JE.ema_init({k: jnp.asarray(v) for k, v in p0.items()})
    ts = TE.ema_init({k: t(v) for k, v in p0.items()})
    for i in range(3):
        new = {k: (v + rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
        js = JE.ema_update(js, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.99)
        ts = TE.ema_update(ts, {k: t(v) for k, v in new.items()}, decay=0.99)
    assert ts.updates == int(js.updates) == 3
    for k in p0:
        close(ts.params[k], np.asarray(js.params[k]), atol=1e-7)
    args = dict(warm_up_steps=100, f_start=1e-6, f_max=1.0, f_min=0.1, cycle_length=1000)
    js, ts = jax_cosine(**args), lambda_warmup_cosine_schedule(**args)
    for n in (0, 1, 99, 100, 101, 550, 999, 1000, 5000):
        assert abs(ts(n) - float(js(n))) <= 1e-7, n


def test_metrics_logger_writes_jax_records(tmp_path):
    """The same metrics.jsonl keys from the same calls."""
    recs = []
    for name, cls in (("jax", JLogger), ("port", MetricsLogger)):
        log = cls(str(tmp_path / name), echo=False)
        log.log(3, {"loss": torch.tensor(0.5) if name == "port" else jnp.float32(0.5), "tag": "x"}, prefix="train")
        log.log(4, {"sec_per_it": 1.25})
        log.close()
        recs.append([json.loads(x) for x in (tmp_path / name / "metrics.jsonl").read_text().splitlines()])
    for a, b in zip(*recs):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "ts"} == {k: v for k, v in b.items() if k != "ts"}


def test_checkpointer_prunes_as_jax_and_round_trips(tmp_path):
    """On one metric sequence both checkpointers keep the same entry names
    (top 2 by lowest metric, plus last); the port's restore is bit-equal, and
    a JAX params npz with a landmark head loads to the head's state dict
    bit-equal."""
    metrics = [(2, 0.5), (4, 0.2), (6, 0.9), (8, 0.1), (10, 0.3)]
    state = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    jc = JCkpt(str(tmp_path / "jax"), keep_top_k=2)
    tc = TrainCheckpointer(str(tmp_path / "port"), keep_top_k=2)
    tstate = {"params": {"unet": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}}
    for step, m in metrics:
        jc.save_last(state, step)
        jc.save_monitored(state, step, m)
        tc.save_last(tstate, step)
        tc.save_monitored(tstate, step, m)
    names = lambda d: sorted(n for n in os.listdir(d) if not n.endswith(".tmp"))
    assert names(tmp_path / "port") == names(tmp_path / "jax") == ["last", "step_00000004", "step_00000008"]
    got = tc.restore_last()
    assert got["step"] == 10 and torch.equal(got["state"]["params"]["unet"]["w"], tstate["params"]["unet"]["w"])
    assert TrainCheckpointer(str(tmp_path / "none")).restore_last() is None
    hp = np_tree(seeded_flax_params(JHead(), jnp.zeros((1, 16, 16, 64)), seed=10))
    jax_save_params_npz(str(tmp_path / "p.npz"), {"landmark_head": hp})
    back, want = load_params_npz(str(tmp_path / "p.npz")), flax_tree_to_state_dict(hp)
    assert back.keys() == {"landmark_head"} and back["landmark_head"].keys() == want.keys()
    assert all(torch.equal(back["landmark_head"][k], v) for k, v in want.items())


def _vae_pair(seed):
    jcfg = JVAEConfig.tiny()
    x = jnp.zeros((1, 32, 32, 3))
    params = seeded_flax_params(JVAE(jcfg), x, seed=seed)
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    return JVAE(jcfg), params, vae


def test_kl_matches_jax():
    """DiagonalGaussian.kl (summed per sample, logvar clamped) within 1e-5 relative."""
    m = np.random.default_rng(14).normal(size=(2, 4, 4, 8)).astype(np.float32) * 3
    close(DiagonalGaussian(t(m)).kl(), np.asarray(JGauss(jnp.asarray(m)).kl()), atol=0, rtol=1e-5)


def test_vae_losses_and_discriminator_match_jax():
    """vae_losses (L1, KL, the gated adversarial term, before and at
    disc_start) and discriminator_loss on the tiny VAE with a seeded
    PatchDiscriminator at 32^2, the posterior's draw JAX's: every log within
    1e-5 relative, the reconstruction within 1e-5 of its peak."""
    jvae, params, vae = _vae_pair(15)
    img = np.random.default_rng(16).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    dparams = seeded_flax_params(JV.PatchDiscriminator(), jnp.asarray(img), seed=17)
    disc = TV.PatchDiscriminator()
    disc.load_state_dict(flax_tree_to_state_dict(np_tree(dparams)))
    rng = jax.random.PRNGKey(4)
    post = jvae.apply({"params": params}, jnp.asarray(img), method=lambda m, x: m.encode(x))
    eps = np.asarray(jax.random.normal(rng, post.mean.shape, post.mean.dtype))
    cfg = TV.VAELossConfig(disc_start=5)
    for step in (4, 5):
        jl, (jrec, jlogs) = JV.vae_losses(jvae, params, dparams, jnp.asarray(img), rng, step, cfg)
        with torch.no_grad():
            tl, (trec, tlogs) = TV.vae_losses(vae, disc, t(img), step, cfg, eps=t(eps))
        assert set(tlogs) == set(jlogs) == {"vae/rec", "vae/kl", "vae/g", "vae/loss"}
        for k in jlogs:
            assert tlogs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-5), (step, k)
        close(trec, np.asarray(jrec), atol=1e-5 * float(jnp.abs(jrec).max()))
    want = float(JV.discriminator_loss(dparams, jnp.asarray(img), jrec))
    with torch.no_grad():
        assert TV.discriminator_loss(disc, t(img), trec).item() == pytest.approx(want, rel=1e-5)


def test_vae_train_step_updates_both_nets():
    """make_vae_train_step: one G step then one D step, each changing only its
    own net, finite logs with the discriminator's loss."""
    _, _, vae = _vae_pair(18)
    disc = TV.PatchDiscriminator()
    for p in disc.parameters():
        torch.nn.init.normal_(p, std=0.05)
    g_opt, d_opt = torch.optim.Adam(vae.parameters(), 1e-3), torch.optim.Adam(disc.parameters(), 1e-3)
    step = TV.make_vae_train_step(vae, disc, g_opt, d_opt, TV.VAELossConfig(disc_start=0))
    v0 = [p.detach().clone() for p in vae.parameters()]
    d0 = [p.detach().clone() for p in disc.parameters()]
    img = t(np.random.default_rng(19).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    logs = step(img, 0, generator=torch.Generator().manual_seed(0))
    assert set(logs) == {"vae/rec", "vae/kl", "vae/g", "vae/loss", "vae/d"}
    assert all(torch.isfinite(v) for v in logs.values())
    assert any(not torch.equal(a, p) for a, p in zip(v0, vae.parameters()))
    assert any(not torch.equal(a, p) for a, p in zip(d0, disc.parameters()))
