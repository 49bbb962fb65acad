"""The port's tiny UNet and VAE against the JAX bundle's, fp32 on the CPU.

Both load the ``tiny_bundle`` params (zero-init convs perturbed, so epsilon
depends on every attention site); the port gets them through
``from_flax_params`` with a strict state-dict load. Tolerance: fp32 round-off
through ~20 layers at |eps| ~ 2.5, atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, port_model, t
from vface_tpu.models.unet import InjectionSpec as JIS
from vface_tpu.ops.attention import FusionConfig as JFC
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.utils.convert import from_flax_params

F = 3  # frames per chunk; the tiny ds1 grid is 16^2 = 256 tokens


@pytest.fixture(scope="module")
def bundles(tiny_bundle):
    model, params = tiny_bundle
    return model, params, port_model(params)


def _inputs(chunks, seed=0):
    rng = np.random.default_rng(seed)
    b = chunks * F
    x = rng.normal(size=(b, 16, 16, 9)).astype(np.float32)
    ts = np.full((b,), 501, np.int32)
    ctx = rng.normal(size=(b, 1, 64)).astype(np.float32)
    flow = (rng.normal(size=(F - 1, 16, 16, 2)) * 2).astype(np.float32)
    return x, ts, ctx, flow


def _eps(bundles, chunks, mode, seed=0):
    jm, params, tm = bundles
    x, ts, ctx, flow = _inputs(chunks, seed)
    replace = chunks == 3
    jinj = JIS(input_blocks=JFC(mode, flow_tokens=256, two_chunk_replace=replace), chunks=chunks)
    tinj = InjectionSpec(input_blocks=FusionConfig(mode, flow_tokens=256, two_chunk_replace=replace),
                         chunks=chunks)
    want = jm.apply_model(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                          flow=jnp.asarray(flow), injection=jinj)
    got = tm.apply_model(t(x), t(ts).long(), t(ctx), flow=t(flow), injection=tinj)
    return got, np.asarray(want)


def test_state_dict_walk_is_exact(bundles):
    """Every Flax leaf lands on exactly one port parameter (strict load), and back."""
    _, params, tm = bundles
    sd = from_flax_params(np_tree({"unet": params["unet"], "vae": params["vae"]}))
    assert set(sd["unet"]) == set(tm.unet.state_dict())
    assert set(sd["vae"]) == set(tm.vae.state_dict())
    w = params["unet"]["in_0_0_attn"]["block_0"]["ff"]["geglu"]["proj"]["kernel"]
    assert torch.equal(tm.unet.in_0_0_attn.block_0.ff.geglu.proj.weight, t(np.asarray(w).T))


@pytest.mark.parametrize("chunks,mode", [(3, "none"), (3, "flow_fix"), (2, "fft"), (2, "flow_fix")])
def test_unet_matches_jax(bundles, chunks, mode):
    """3 chunks: the literal [uncond, cond, recon] batch. 2 chunks: the
    recon-free semantics (two_chunk_replace=False, fusion applied to chunk 1)."""
    got, want = _eps(bundles, chunks, mode)
    close(got, want, atol=2e-5)


def test_fgats_engages_on_the_tiny_grid(bundles):
    """flow_fix differs from fft only through FGATS: it must change chunk 1."""
    fft, _ = _eps(bundles, 2, "fft")
    flow_fix, _ = _eps(bundles, 2, "flow_fix")
    assert torch.equal(fft[:F], flow_fix[:F])  # the donor chunk is untouched
    assert (fft[F:] - flow_fix[F:]).abs().max() > 1e-3


def test_vae_encode_decode_match_jax(bundles):
    jm, params, tm = bundles
    img = np.random.default_rng(4).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    jz = np.asarray(jm.encode_first_stage(params, jnp.asarray(img)))
    close(tm.encode_first_stage(t(img)), jz, atol=5e-6)
    jd = np.asarray(jm.decode_first_stage(params, jnp.asarray(jz)))
    close(tm.decode_first_stage(t(jz)), jd, atol=2e-5)


def test_q_sample(bundles):
    jm, _, tm = bundles
    rng = np.random.default_rng(5)
    z0, noise = rng.normal(size=(2, 4, 4, 4)).astype(np.float32), rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    ts = np.asarray([1, 981])
    want = jm.q_sample(jnp.asarray(z0), jnp.asarray(ts), jnp.asarray(noise))
    close(tm.q_sample(t(z0), t(ts).long(), t(noise)), want, atol=1e-6)


def test_full_topology_with_kernel_routing_matches_jax():
    """The SD-v1 UNet topology (4 levels, attention at ds 1/2/4, 2 res blocks,
    8 heads) at width 32 with ``use_flash`` and ``use_fused_ff`` on, as
    ``sd_v1_inpaint`` sets them, on a 32^2 latent: the ds1 sites (N = 1024)
    take the flash-attention route and every FF the fused-GEGLU route, whose
    plain versions run on the CPU (JAX falls back to its einsum and XLA
    paths off the TPU). fp32; FGATS engaged at ds1. atol 5e-5 at |eps| ~ 3."""
    import dataclasses

    import jax

    from vface_tpu.models.unet import UNetConfig as JCfg, UNetModel as JUNet
    from vface_torch.models.unet import UNetConfig, UNetModel
    from vface_torch.ops import flash_attention as FA
    from vface_torch.utils.convert import flax_tree_to_state_dict

    kw = dict(model_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=2, num_heads=8,
              context_dim=64, use_flash=True, use_fused_ff=True)
    jcfg = JCfg(use_remat=False, **kw)
    rng = np.random.default_rng(11)
    f, side = 2, 32
    x = rng.normal(size=(2 * f, side, side, 9)).astype(np.float32)
    ts = np.full((2 * f,), 961, np.int32)
    ctx = rng.normal(size=(2 * f, 1, 64)).astype(np.float32)
    flow = (rng.normal(size=(f - 1, side, side, 2)) * 2).astype(np.float32)
    jnet = JUNet(jcfg)
    params = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [p + 0.05 * jax.random.normal(k, p.shape) if not p.any() else p for p, k in zip(leaves, keys)])
    jinj = JIS(input_blocks=JFC("flow_fix", flow_tokens=side * side, two_chunk_replace=False), chunks=2)
    want = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                      flow=jnp.asarray(flow), injection=jinj)
    net = UNetModel(UNetConfig(**kw))
    net.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    assert net.in_0_0_attn.block_0.attn1.use_flash and net.in_0_0_attn.block_0.ff.use_fused
    tinj = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=side * side,
                                                   two_chunk_replace=False), chunks=2)
    from unittest import mock

    from vface_torch.models import unet as unet_mod

    routed = {"flash_attention": 0, "geglu_ff": 0}

    def spy(name):
        real = getattr(unet_mod, name)

        def call(*args):
            routed[name] += 1
            return real(*args)
        return call

    before = dict(FA.LAUNCHES)
    with torch.no_grad(), mock.patch.object(unet_mod, "flash_attention", spy("flash_attention")), \
            mock.patch.object(unet_mod, "geglu_ff", spy("geglu_ff")):
        got = net(t(x), t(ts).long(), t(ctx), flow=t(flow), injection=tinj)
    # 5 ds1 sites take the flash route (ds2/ds4 have N < 512 here); all 16 FFs the fused route
    assert routed == {"flash_attention": 5, "geglu_ff": 16}
    assert FA.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    close(got, np.asarray(want), atol=5e-5)
