"""The rest of the samplers against the JAX package's: the UNet's encoder cache,
``encoder_key_steps``, ``vface_sample`` with encoder propagation, ``eta > 0``
and ``src_start``, ``vface_sample_pipelined`` at ``eta > 0``, ``ddim_invert``
with CFG and the encoder cache, and ``ddim_sample``.

Tiny UNet (``ModelConfig.tiny(image_size=32)``) with seeded params that hold no
zero convolution (the fresh init's zero output convolutions would hide a
stale cache), fp32 on the CPU; 2 frames of 8 x 8 latents, 5 steps, FSAI +
FGATS at the 64-token ds1 grid. Each JAX sampler call draws its noise from
``PRNGKey(0)``; the port's calls are handed a source replaying those draws.

Limits: one UNet eval within 1e-5 (fp32 round-off); a sampler's latents
within 1e-4 (five evals, CFG amplifying each eps difference by the scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, jax_noise, port_model, seeded_bundle_params, t
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.samplers.ddim import ddim_sample
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.vface import encoder_key_steps, vface_sample, vface_sample_pipelined

F, HL, D, S = 2, 8, 64, 5  # frames, latent side, context width, steps (a divisor of 1000)


@pytest.fixture(scope="module")
def bundle():
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel

    jm = JModel(JConfig.tiny(image_size=32))
    params = seeded_bundle_params(jm, seed=21)
    r = np.random.default_rng(22)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    data = dict(x_T=n(F, HL, HL, 4), cond=n(F, 1, D), uncond=n(F, 1, D), tcond=n(F, 1, D),
                inv=n(S, F, HL, HL, 4), inpaint=n(F, HL, HL, 4),
                mask=(r.uniform(size=(F, HL, HL, 1)) > 0.5).astype(np.float32), flow=n(F - 1, HL, HL, 2, scale=1.5),
                src=n(F, HL, HL, 4), next_z0=n(F, HL, HL, 4), next_cond=n(F, 1, D))
    return dict(jm=jm, params=params, model=port_model(params), d=data)


def _injections():
    from vface_tpu.models.unet import InjectionSpec as JInjectionSpec
    from vface_tpu.ops.attention import FusionConfig as JFusionConfig

    return (JInjectionSpec(input_blocks=JFusionConfig("flow_fix", flow_tokens=HL * HL), chunks=3),
            InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=HL * HL), chunks=3))


def _x9(d, n):
    return np.concatenate([d["x_T"], d["inpaint"], d["mask"]], axis=-1)[:n]


def test_full_call_equals_cache_returning_call(bundle):
    """``return_encoder_cache`` changes nothing of the output; the cache is the
    skip stack (conv_in, each input block, each downsample) and the middle
    block's output, NCHW."""
    x9, ctx = t(_x9(bundle["d"], F)), t(bundle["d"]["cond"])
    ts = torch.full((F,), 500, dtype=torch.int64)
    with torch.inference_mode():
        eps = bundle["model"].apply_model(x9, ts, ctx)
        eps2, (skips, mid) = bundle["model"].apply_model(x9, ts, ctx, return_encoder_cache=True)
    assert torch.equal(eps, eps2)
    assert [tuple(s.shape[1:]) for s in skips] == [(32, 8, 8), (32, 8, 8), (32, 4, 4), (64, 4, 4)]
    assert tuple(mid.shape) == (F, 64, 4, 4)
    zeros = bundle["model"].unet.zero_encoder_cache(F, HL, HL)
    assert [s.shape for s in zeros[0]] == [s.shape for s in skips] and zeros[1].shape == mid.shape


def test_cached_call_matches_jax(bundle):
    """The cache of a full call at t = 500 fed to a call at t = 300 (output
    blocks only, with t = 300's embedding): within 1e-5 of JAX's same two
    calls, the cache returned as given; and 1e-2 or more away from a full call
    at t = 300, so a stale cache shows."""
    jm, params, model = bundle["jm"], bundle["params"], bundle["model"]
    x9, ctx = _x9(bundle["d"], F), bundle["d"]["cond"]
    t1, t2 = np.full((F,), 500, np.int32), np.full((F,), 300, np.int32)
    _, jcache = jm.apply_model(params, x9, t1, ctx, return_encoder_cache=True)
    want, jback = jm.apply_model(params, x9, t2, ctx, encoder_cache=jcache, return_encoder_cache=True)
    assert jback is jcache
    with torch.inference_mode():
        _, cache = model.apply_model(t(x9), t(t1).long(), t(ctx), return_encoder_cache=True)
        got, back = model.apply_model(t(x9), t(t2).long(), t(ctx), encoder_cache=cache, return_encoder_cache=True)
        full = model.apply_model(t(x9), t(t2).long(), t(ctx))
    assert back is cache
    close(got, np.asarray(want), atol=1e-5)
    assert float((got - full).abs().max()) > 1e-2


@pytest.mark.parametrize("steps", [1, 2, 5, 10, 49, 50])
def test_encoder_key_steps_matches_jax(steps):
    from vface_tpu.samplers.vface import encoder_key_steps as jax_key_steps

    for interval in (1, 2, 3, 4):
        for frac in (0.2, 0.5):
            want = np.asarray(jax_key_steps(steps, interval, frac)).tolist()
            assert encoder_key_steps(steps, interval, frac) == want, (steps, interval, frac)


SAMPLE_CASES = {
    "interval2": dict(encoder_interval=2),
    "interval3": dict(encoder_interval=3),
    "eta": dict(eta=0.5),
    "src_start": dict(src_start=True),
}


@pytest.mark.parametrize("drop", [False, True], ids=["recon", "recon_free"])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_vface_sample_matches_jax(bundle, case, drop):
    """``vface_sample`` (5 steps, CFG 3, FSAI + FGATS) with encoder propagation at
    interval 2 and 3, with eta = 0.5 on JAX's draws, and with ``src_start``, on
    the 3-chunk and the recon-free batch: z_0 and the pred_x0 trajectory
    within 1e-4 of JAX's. Each option moves z_0 away from the exact loop's."""
    from vface_tpu.samplers.vface import vface_sample as jax_vface_sample

    d = bundle["d"]
    kw = dict(SAMPLE_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("src_start", False):
        jkw["src_start"], tkw["src_start"] = jnp.asarray(d["src"]), t(d["src"])
    if "eta" in kw:
        tkw["noise"] = jax_noise()
    jinj, inj = _injections()
    args = [d[k] for k in ("x_T", "cond", "uncond", "tcond", "inv", "inpaint", "mask")]
    common = dict(num_steps=S, cfg_scale=3.0, drop_recon_chunk=drop)
    wz, wtraj = jax_vface_sample(bundle["jm"], bundle["params"], *map(jnp.asarray, args), jinj,
                                 flow=jnp.asarray(d["flow"]), **common, **jkw)
    with torch.inference_mode():
        z, traj = vface_sample(bundle["model"], *map(t, args), inj, flow=t(d["flow"]), **common, **tkw)
        exact, _ = vface_sample(bundle["model"], *map(t, args), inj, flow=t(d["flow"]), **common)
    close(z, np.asarray(wz), atol=1e-4)
    close(traj, np.asarray(wtraj), atol=1e-4)
    assert float((z - exact).abs().max()) > 1e-3


def test_vface_sample_refuses_the_carry_with_the_cache(bundle):
    """A cached step gives no FGATS carry: the JAX package's ``lax.cond`` refuses
    the two branches' different carries, and the port refuses the call."""
    d = bundle["d"]
    args = [t(d[k]) for k in ("x_T", "cond", "uncond", "tcond", "inv", "inpaint", "mask")]
    with pytest.raises(ValueError, match="encoder_interval"):
        vface_sample(bundle["model"], *args, _injections()[1], flow=t(d["flow"]), num_steps=S, encoder_interval=2,
                     return_fgats_carry=True)


def test_vface_sample_pipelined_with_eta_matches_jax(bundle):
    """Pack i's recon-free sampling (eta = 0.5, JAX's draws) fused with pack
    i+1's inversion (5 steps, ``skip_last=1``): z_0, the trajectory and the
    next start code within 1e-4 of JAX's."""
    from vface_tpu.samplers.vface import vface_sample_pipelined as jax_pipelined

    d = bundle["d"]
    jinj, inj = _injections()
    args = [d[k] for k in ("x_T", "cond", "uncond", "inpaint", "mask")]
    nxt = dict(next_z0=d["next_z0"], next_cond=d["next_cond"], next_inpaint=d["inpaint"][::-1].copy(),
               next_mask=d["mask"][::-1].copy())
    common = dict(inversion_steps=S, skip_last=1, num_steps=S, cfg_scale=3.0, eta=0.5)
    want = jax_pipelined(bundle["jm"], bundle["params"], *map(jnp.asarray, args), jinj,
                         **{k: jnp.asarray(v) for k, v in nxt.items()}, flow=jnp.asarray(d["flow"]), **common)
    with torch.inference_mode():
        got = vface_sample_pipelined(bundle["model"], *map(t, args), inj, **{k: t(v) for k, v in nxt.items()},
                                     flow=t(d["flow"]), noise=jax_noise(), **common)
    for g, w in zip(got, want):
        close(g, np.asarray(w), atol=1e-4)


INVERT_CASES = {
    "cfg": dict(cfg_scale=2.0, uncond=True),
    "cache": dict(encoder_interval=3),  # the first step is a key step
    "cache_zero_start": dict(encoder_interval=2),  # it is not: the first step runs on zeros
    "cfg_cache": dict(cfg_scale=2.0, uncond=True, encoder_interval=2, skip_last=1),
}


@pytest.mark.parametrize("case", sorted(INVERT_CASES))
def test_ddim_invert_matches_jax(bundle, case):
    """``ddim_invert`` (5 steps) with CFG (scale 2), with encoder propagation
    (the key mask read mirrored; at interval 2 the first step is no key step
    and runs on a cache of zeros, as JAX's does), and both with ``skip_last``:
    x_T and the latent stack within 1e-4 of JAX's."""
    from vface_tpu.samplers.inversion import ddim_invert as jax_ddim_invert

    d = bundle["d"]
    kw = dict(INVERT_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("uncond"):
        jkw["uncond"], tkw["uncond"] = jnp.asarray(d["uncond"]), t(d["uncond"])
    args = [d[k] for k in ("x_T", "cond", "inpaint", "mask")]
    wx, wlat = jax_ddim_invert(bundle["jm"], bundle["params"], *map(jnp.asarray, args), num_steps=S, keep=1, **jkw)
    with torch.inference_mode():
        x, lat = ddim_invert(bundle["model"], *map(t, args), num_steps=S, keep=1, **tkw)
        exact, _ = ddim_invert(bundle["model"], *map(t, args), num_steps=S, keep=1)
    close(x, np.asarray(wx), atol=1e-4)
    close(lat, np.asarray(wlat), atol=1e-4)
    assert float((x - exact).abs().max()) > 1e-3


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_matches_jax(bundle, eta):
    """``ddim_sample`` (5 steps, CFG 3) at eta 0 and 0.5 (JAX's draws): z_0 and
    the pred_x0 trajectory within 1e-4 of JAX's."""
    from vface_tpu.samplers.ddim import ddim_sample as jax_ddim_sample

    d = bundle["d"]
    args = [d[k] for k in ("x_T", "cond", "uncond", "inpaint", "mask")]
    wz, wtraj = jax_ddim_sample(bundle["jm"], bundle["params"], *map(jnp.asarray, args), num_steps=S,
                                cfg_scale=3.0, eta=eta)
    with torch.inference_mode():
        z, traj = ddim_sample(bundle["model"], *map(t, args), num_steps=S, cfg_scale=3.0, eta=eta,
                              noise=jax_noise())
    assert tuple(traj.shape) == (S, F, HL, HL, 4)
    close(z, np.asarray(wz), atol=1e-4)
    close(traj, np.asarray(wtraj), atol=1e-4)


def test_default_noise_is_seeded_afresh_on_each_call(bundle):
    """Without a noise source each call draws from a generator seeded with 0:
    two calls agree bit for bit, and eta > 0 moves z_0 from eta = 0."""
    d = bundle["d"]
    args = [t(d[k]) for k in ("x_T", "cond", "uncond", "inpaint", "mask")]
    with torch.inference_mode():
        a, b = (ddim_sample(bundle["model"], *args, num_steps=3, eta=0.5)[0] for _ in range(2))
        z0 = ddim_sample(bundle["model"], *args, num_steps=3)[0]
    assert torch.equal(a, b)
    assert float((a - z0).abs().max()) > 1e-3
