"""The port's building blocks against their JAX counterparts, fp32 on the CPU.

Each JAX module is initialised with Flax, its params go through the port's
``from_flax_params`` walk (``flax_tree_to_state_dict``), and both sides see the
same seeded numpy input. Tolerances are fp32 round-off at the stated scale
unless a test says otherwise.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t
from vface_tpu.models import layers as JL
from vface_tpu.models import vae as JV
from vface_tpu.ops import attention as JA
from vface_tpu.ops import fusion as JF
from vface_tpu.ops import warp as JW
from vface_tpu.utils import schedule as JS
from vface_torch.models import layers as TL
from vface_torch.models import vae as TV
from vface_torch.ops import attention as TA
from vface_torch.ops import fusion as TF
from vface_torch.ops import warp as TW
from vface_torch.utils import schedule as TS
from vface_torch.utils.convert import flax_tree_to_state_dict, init_params

REPO = Path(__file__).resolve().parents[1]


def _port(jmod, tmod, x_nhwc, seed=0, nchw=True):
    """Init the Flax module on x, load its params into the port module, run both."""
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))["params"]
    flat = jax.tree_util.tree_flatten(params)[0]
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(flat))
    # zero-initialised leaves (biases, norm offsets) get values so they are tested
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [p + 0.1 * jax.random.normal(k, p.shape) for p, k in zip(flat, keys)],
    )
    tmod.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x_nhwc)))
    xt = t(x_nhwc).permute(0, 3, 1, 2) if nchw else t(x_nhwc)
    got = tmod(xt)
    got = got.permute(0, 2, 3, 1) if nchw else got
    return got.detach(), want


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("steps", [2, 3, 50])
def test_schedule_tables_are_bit_identical(steps):
    jb, tb = JS.DiffusionSchedule.create(), TS.DiffusionSchedule.create()
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(jb, name), getattr(tb, name))
    jd, td = JS.DDIMSchedule.create(jb, steps), TS.DDIMSchedule.create(tb, steps)
    for name in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas",
                 "inv_alpha_next", "inv_alpha_cur"):
        np.testing.assert_array_equal(getattr(jd, name), getattr(td, name))


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    """fp32 exp of the frequencies may differ by an ulp between the libraries;
    at t = 981 that ulp of the argument (~6e-5 rad) shows in cos/sin: atol 1.5e-4."""
    ts = np.asarray([0, 1, 21, 501, 961, 981])
    want = JS.timestep_embedding(jnp.asarray(ts), dim)
    close(TS.timestep_embedding(t(ts), dim), want, atol=1.5e-4)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("eps,shape", [(1e-5, (2, 8, 8, 64)), (1e-6, (2, 8, 8, 32)),
                                       (1e-6, (1, 128, 128, 128))])
def test_groupnorm32(eps, shape):
    """The last shape is K3-eligible (h*w >= 2^14, >= 2^21 elements); on the CPU
    the wrapper takes the plain sums."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 3 + 1
    got, want = _port(JL.GroupNorm32(epsilon=eps), TL.GroupNorm32(shape[-1], eps=eps), x)
    assert TL.gn_kernel_eligible(t(x).permute(0, 3, 1, 2)) == (shape[1] >= 128)
    close(got, want, atol=2e-5)


def test_layernorm_f32():
    x = np.random.default_rng(2).normal(size=(2, 10, 48)).astype(np.float32) + 2
    got, want = _port(JL.LayerNormF32(), TL.LayerNormF32(48), x, nchw=False)
    close(got, want, atol=2e-6)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_torch_padding(kernel, stride):
    """Symmetric TORCH padding, stride 2 included (flax SAME would shift the grid)."""
    x = np.random.default_rng(3).normal(size=(2, 9, 9, 8)).astype(np.float32)
    got, want = _port(JL.Conv(16, kernel=kernel, stride=stride),
                      TL.Conv(8, 16, kernel=kernel, stride=stride), x)
    close(got, want, atol=2e-5)


def test_vae_downsample_pads_asymmetrically():
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 16)).astype(np.float32)
    got, want = _port(JV.Downsample(16), TV.Downsample(16), x)
    assert got.shape == (2, 4, 4, 16)
    close(got, want, atol=2e-5)


def test_dense():
    x = np.random.default_rng(5).normal(size=(3, 7, 24)).astype(np.float32)
    got, want = _port(JL.Dense(40), TL.Dense(24, 40), x, nchw=False)
    close(got, want, atol=2e-5)


@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_dense_and_conv_round_like_flax_at_bf16(layer):
    """At dtype bf16 Flax's nn.Dense / nn.Conv round the product to bf16, then
    add the bias in bf16; so do the port's. Same seeded params, a bias
    comparable to the product. Each element within 1 bf16 ulp of the final
    add's larger operand (the products sum in another order), and at least
    99% bit-equal: adding the bias before the one rounding, as a fused
    F.linear / F.conv2d does, leaves ~69% bit-equal (0.691 Dense, 0.689 Conv)."""
    import flax.linen as nn

    rng = np.random.default_rng(21)
    if layer == "dense":
        x = rng.normal(size=(4, 64, 320)).astype(np.float32)
        k = (rng.normal(size=(320, 640)) / np.sqrt(320)).astype(np.float32)
        jmod = nn.Dense(640, dtype=jnp.bfloat16, param_dtype=jnp.float32)
        tmod, w = TL.Dense(320, 640, dtype=torch.bfloat16), k.T
        xt = t(x)
    else:
        x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
        k = (rng.normal(size=(3, 3, 32, 64)) / np.sqrt(9 * 32)).astype(np.float32)
        jmod = nn.Conv(64, (3, 3), padding=((1, 1), (1, 1)), dtype=jnp.bfloat16, param_dtype=jnp.float32)
        tmod, w = TL.Conv(32, 64, 3, dtype=torch.bfloat16), k.transpose(3, 2, 0, 1)
        xt = t(x).permute(0, 3, 1, 2)
    b = (0.5 * rng.normal(size=(k.shape[-1],))).astype(np.float32)
    want = np.asarray(jmod.apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x)), np.float32)
    tmod.load_state_dict({"weight": t(np.ascontiguousarray(w)), "bias": t(b)})
    with torch.no_grad():
        got = tmod(xt)
    assert got.dtype == torch.bfloat16
    got = (got if layer == "dense" else got.permute(0, 2, 3, 1)).float().numpy()
    bias = np.abs(np.asarray(b, ml_dtypes.bfloat16).astype(np.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(want), bias), 2.0**-126))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() >= 0.99


def _tiny_bf16_unet():
    """The tiny UNet at bf16 on both sides from one seeded set of params, its
    2 x 8^2 input, and each top-level layer's inputs and output in the port's
    run: (jnet, params, net, (x, ts, ctx), {name: (args, out)})."""
    import dataclasses

    from _torch_port import seeded_flax_params
    from vface_tpu.models.unet import UNetConfig as JCfg, UNetModel as JUNet
    from vface_torch.models.unet import UNetConfig, UNetModel

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 9)).astype(np.float32)
    ts = np.full((2,), 501, np.int32)
    ctx = rng.normal(size=(2, 1, 64)).astype(np.float32)
    jnet = JUNet(dataclasses.replace(JCfg.tiny(), dtype=jnp.bfloat16))
    params = seeded_flax_params(jnet, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), seed=3)
    net = UNetModel(dataclasses.replace(UNetConfig.tiny(), dtype=torch.bfloat16))
    net.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    seen = {}
    hooks = [m.register_forward_hook(lambda m, a, o, name=name: seen.setdefault(name, (a, o)) and None)
             for name, m in net.named_children()]
    with torch.no_grad():
        seen["unet"] = ((t(x), t(ts).long(), t(ctx)), net(t(x), t(ts).long(), t(ctx)))
    for h in hooks:
        h.remove()
    return jnet, params, net, (x, ts, ctx), seen


# the tiny UNet's top-level layers, in call order, and the whole net
BF16_LAYERS = ("time_embed_0", "time_embed_2", "conv_in", "in_0_0_res", "in_0_0_attn", "in_0_down", "in_1_0_res",
               "in_1_0_attn", "mid_res_0", "mid_attn", "mid_res_1", "out_1_0_res", "out_1_0_attn", "out_1_1_res",
               "out_1_1_attn", "out_1_up", "out_0_0_res", "out_0_0_attn", "out_0_1_res", "out_0_1_attn", "out_norm",
               "out_conv", "unet")


def _jax_layer(jnet, params, name, args, out_ch):
    """JAX's layer ``name`` (``out_ch`` output channels) of the tiny bf16 UNet on
    the port's inputs to it (NCHW to NHWC, bf16 kept bf16): (a function of the
    layer's params, its params)."""
    from vface_tpu.models import unet as JU
    from vface_tpu.ops.attention import FusionConfig as JFusionConfig

    cfg, bf = jnet.cfg, jnp.bfloat16
    if name == "unet":
        x, ts, ctx = (jnp.asarray(a.numpy()) for a in args)
        return lambda p: jnet.apply({"params": p}, x, ts, ctx), params
    nhwc = lambda a: (a.permute(0, 2, 3, 1) if a.ndim == 4 else a).float().numpy()
    arr = [jnp.asarray(nhwc(a)).astype(bf if a.dtype == torch.bfloat16 else jnp.float32)
           for a in args if torch.is_tensor(a)]
    ch = args[0].shape[1]
    if name.startswith("time_embed"):
        mod = JL.Dense(cfg.model_channels * 4, dtype=bf)
    elif name == "conv_in":
        mod = JL.Conv(cfg.model_channels, dtype=bf)
    elif "_res" in name:
        mod = JU.ResBlock(out_ch, dtype=bf)
    elif name.endswith("attn"):
        mod = JU.SpatialTransformer(ch, cfg.context_dim, cfg.num_heads, cfg.transformer_depth, dtype=bf)
        arr = [arr[0], arr[1], JFusionConfig("none"), 3, None]
    elif name.endswith("down"):
        mod = JU.Downsample(ch, dtype=bf)
    elif name.endswith("up"):
        mod = JU.Upsample(ch, dtype=bf)
    elif name == "out_norm":
        mod = JL.GroupNorm32(dtype=bf)
    else:
        mod = JL.Conv(cfg.out_channels, zero_init=True, dtype=bf)
    return lambda p: mod.apply({"params": p}, *arr), params[name]


def _nhwc_np(a) -> np.ndarray:
    return (a.permute(0, 2, 3, 1) if a.ndim == 4 else a).float().numpy()


@pytest.fixture(scope="module")
def bf16_unet():
    return _tiny_bf16_unet()


def test_tiny_unet_at_bf16_matches_jax(bf16_unet):
    """The tiny UNet at dtype bf16 on both sides, the same seeded params, on a
    2 x 8^2 latent, jitted on the JAX side: within 4 bf16 ulps of the output's
    peak. Op by op the port is JAX's bit for bit
    (:func:`test_tiny_unet_layer_at_bf16_matches_jax`); the jit moves roundings:
    XLA keeps fused bf16 chains at float32 (``xla_allow_excess_precision``) and
    sums its products in another order. 3.48 ulps measured (2.48 while the
    SiLU rounded once, 3.04 before Conv/Dense rounded like Flax)."""
    jnet, params, _, (x, ts, ctx), seen = bf16_unet
    run = jax.jit(lambda p, a, s, c: jnet.apply({"params": p}, a, s, c))
    want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx)), np.float32)
    got = seen["unet"][1]
    assert np.isfinite(got.float().numpy()).all()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    close(got, want, atol=4 * ulp)


@pytest.mark.parametrize("name", BF16_LAYERS)
def test_tiny_unet_layer_at_bf16_matches_jax(bf16_unet, name):
    """Each top-level layer of the tiny bf16 UNet on the port's own inputs to
    it, and the whole net, against JAX's applied op by op (each op rounding to
    bf16 as written): within 1 bf16 ulp of each element and equal on >= 99.9 %
    of them. Measured: every layer and the net equal, but one element of
    ``out_1_up`` (a 3x3 convolution's sum in another order, 1 ulp)."""
    jnet, params, _, _, seen = bf16_unet
    args, out = seen[name]
    fn, p = _jax_layer(jnet, params, name, args, out.shape[1] if out.ndim == 4 else None)
    want = np.asarray(fn(p), np.float32)
    got = _nhwc_np(out) if name != "unet" else out.float().numpy()
    assert got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() >= 0.999


def test_silu_at_bf16_rounds_as_jax():
    """At bf16 the port's SiLU rounds where ``jax.nn.silu`` does (``exp(-x)``,
    ``1 + e``, ``1 / d`` and the product, each to bf16): equal on >= 99.9 % of 2e5
    seeded values, within 1 bf16 ulp of each (the two libraries' float32 exp
    can differ in the last place and move a rounding). ``F.silu`` rounds once
    and matched 61 %. With a gradient the forward is the same, and the
    backward is ``F.silu``'s, which keeps only x."""
    x = (np.random.default_rng(8).normal(size=(200000,)) * 3).astype(np.float32)
    xb = t(x).to(torch.bfloat16)
    want = np.asarray(JL.nonlinearity(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)), np.float32)
    got = TL.nonlinearity(xb)
    assert got.dtype == torch.bfloat16
    xg = xb.clone().requires_grad_()
    traced = TL.nonlinearity(xg)
    assert torch.equal(traced.detach(), got)
    g = t(np.random.default_rng(9).normal(size=x.shape).astype(np.float32)).to(torch.bfloat16)
    xf = xb.clone().requires_grad_()
    assert torch.equal(torch.autograd.grad(traced, xg, g)[0],
                       torch.autograd.grad(torch.nn.functional.silu(xf), xf, g)[0])
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() >= 0.999


def test_self_attention_2d():
    x = np.random.default_rng(6).normal(size=(2, 6, 6, 32)).astype(np.float32)
    got, want = _port(JL.SelfAttention2D(), TL.SelfAttention2D(32), x)
    close(got, want, atol=2e-5)


def test_upsample_and_silu():
    x = np.random.default_rng(7).normal(size=(2, 3, 5, 4)).astype(np.float32)
    xt = t(x).permute(0, 3, 1, 2)
    close(TL.upsample_nearest_2x(xt).permute(0, 2, 3, 1), JL.upsample_nearest_2x(jnp.asarray(x)), atol=0)
    close(TL.nonlinearity(t(x)), JL.nonlinearity(jnp.asarray(x)), atol=1e-6)


# ------------------------------------------------------------------- fusion
@pytest.mark.parametrize("d", [32, 320])
def test_fsai_circulant_equals_fft(d):
    rng = np.random.default_rng(d)
    donor, branch = rng.normal(size=(2, 16, d)).astype(np.float32), rng.normal(size=(2, 16, d)).astype(np.float32)
    circ = TF.combine_fft_high_low_circulant(t(donor), t(branch))
    close(circ, TF.combine_fft_high_low(t(donor), t(branch)), atol=2e-5)
    close(circ, JF.combine_fft_high_low_circulant(jnp.asarray(donor), jnp.asarray(branch)), atol=2e-5)
    close(TF.combine_fft_high_low(t(donor), t(branch)),
          JF.combine_fft_high_low(jnp.asarray(donor), jnp.asarray(branch)), atol=2e-5)


# --------------------------------------------------------------------- warp
def test_grid_sample_wide_channels():
    rng = np.random.default_rng(8)
    img = rng.normal(size=(2, 9, 11, 40)).astype(np.float32)
    coords = (rng.uniform(-2, 12, size=(2, 9, 11, 2))).astype(np.float32)
    close(TW.grid_sample(t(img), t(coords)), JW.grid_sample(jnp.asarray(img), jnp.asarray(coords)), atol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_align_by_flow(with_mask):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 8, 8, 24)).astype(np.float32)
    flow = (rng.normal(size=(3, 8, 8, 2)) * 2).astype(np.float32)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32) if with_mask else None
    want = JW.align_by_flow(jnp.asarray(x), jnp.asarray(flow), 0.8,
                            pair_mask=None if mask is None else jnp.asarray(mask))
    got = TW.align_by_flow(t(x), t(flow), 0.8, pair_mask=None if mask is None else t(mask))
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(32, 16), (64, 8), (8, 16)])
def test_resize_flow(src, dst):
    """2x and 8x downsampling (JAX antialiases them) and an upsample."""
    flow = (np.random.default_rng(src).normal(size=(2, src, src, 2)) * 3).astype(np.float32)
    close(TW.resize_flow(t(flow), dst, dst), JW.resize_flow(jnp.asarray(flow), dst, dst), atol=2e-5)


def test_keep_mask_resize_8x():
    """The 512 -> 64 keep-mask resize of the swap, at 128 -> 16: a hard-edged mask."""
    m = np.zeros((2, 128, 128, 1), np.float32)
    m[:, 20:90, 35:101] = 1.0
    want = jax.image.resize(jnp.asarray(m), (2, 16, 16, 1), method="bilinear")
    close(TW.resize_bilinear(t(m), 16, 16), want, atol=1e-6)


# ------------------------------------------------------------ fuse / attend
@pytest.mark.parametrize("mode,chunks,replace,masked", [
    ("fft", 3, True, False), ("flow_fix", 3, True, False), ("fft", 2, True, False),
    ("flow_fix", 2, True, False), ("fft", 2, False, False), ("flow_fix", 2, False, False),
    ("flow_fix", 3, True, True),
])
def test_fuse_qkv(mode, chunks, replace, masked):
    rng = np.random.default_rng(10)
    f, side, d = 3, 4, 16
    n = side * side
    q, k, v = [rng.normal(size=(chunks * f, n, d)).astype(np.float32) for _ in range(3)]
    flow = (rng.normal(size=(f - 1, side, side, 2)) * 1.5).astype(np.float32)
    mask = np.asarray([0.0, 1.0], np.float32) if masked else None
    jc = JA.FusionConfig(mode, flow_tokens=n, two_chunk_replace=replace)
    tc = TA.FusionConfig(mode, flow_tokens=n, two_chunk_replace=replace)
    jq, jk, jv, _ = JA.fuse_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc, chunks=chunks,
                                flow=jnp.asarray(flow), pair_mask=None if mask is None else jnp.asarray(mask))
    tq, tk, tv, _ = TA.fuse_qkv(t(q), t(k), t(v), tc, chunks=chunks, flow=t(flow),
                                pair_mask=None if mask is None else t(mask))
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        close(got, want, atol=2e-5)


def test_multi_head_attention():
    rng = np.random.default_rng(11)
    q, k, v = [rng.normal(size=(2, 20, 32)).astype(np.float32) for _ in range(3)]
    want = JA.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4)
    close(TA.multi_head_attention(t(q), t(k), t(v), 4), want, atol=2e-6)


# ------------------------------------------------------------ params, guard
def test_init_params_is_seeded_and_fills_zero_init_convs():
    from vface_torch.models.ldm import ModelConfig

    cfg = ModelConfig.tiny()
    a = init_params(cfg, torch.Generator().manual_seed(7))
    b = init_params(cfg, torch.Generator().manual_seed(7))
    assert a["unet"].keys() == b["unet"].keys()
    assert all(torch.equal(a["unet"][k], b["unet"][k]) for k in a["unet"])
    for key in ("out_conv.weight", "in_0_0_res.out_conv.weight", "in_0_0_attn.proj_out.weight"):
        assert a["unet"][key].abs().max() > 0
    assert a["unet"]["in_0_0_res.in_norm.weight"].eq(1).all()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of vface_torch imports with jax, flax and vface_tpu blocked
    (the walk reaches every subpackage: one without an ``__init__.py`` would
    hide its modules from it, so modules of each subpackage are named), and
    chip_smoke.py names none of them in an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'vface_tpu'): sys.modules[m] = None\n"
        "import vface_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vface_torch.__path__, 'vface_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "assert {'vface_torch.io.video', 'vface_torch.io.image', 'vface_torch.runtime.checkpoint',\n"
        "        'vface_torch.data.datasets', 'vface_torch.utils.config',\n"
        "        'vface_torch.scripts.vface_video_swap', 'vface_torch.preprocess.align',\n"
        "        'vface_torch.preprocess.detector', 'vface_torch.preprocess.tps', 'vface_torch.eval.lpips',\n"
        "        'vface_torch.pipelines.train_driver', 'vface_torch.pipelines.vae_train',\n"
        "        'vface_torch.scripts.train', 'vface_torch.utils.ema', 'vface_torch.utils.logging',\n"
        "        'vface_torch.utils.profiling', 'vface_torch.pipelines.image_swap', 'vface_torch.samplers.plms',\n"
        "        'vface_torch.samplers.guided', 'vface_torch.utils.watermark',\n"
        "        'vface_torch.scripts.inference_test_bench', 'vface_torch.scripts.one_inference'} <= set(mods), mods\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'vface_tpu') and sys.modules[k] is not None\n"
        "               for k in list(sys.modules))\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "flax", "vface_tpu")]


if __name__ == "__main__":
    # The per-layer table of the tiny bf16 UNet's gap to JAX (ROADMAP §C):
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_layers.py [--fused-silu]
    # (--fused-silu: the port's SiLU as F.silu, one rounding, as before it
    # rounded like jax.nn.silu)
    import conftest  # noqa: F401  (JAX on the CPU)
    from unittest import mock

    from vface_torch.models import unet as unet_mod

    fused = "--fused-silu" in sys.argv
    with mock.patch.object(unet_mod, "nonlinearity", torch.nn.functional.silu) if fused else mock.MagicMock():
        jnet, params, _, _, seen = _tiny_bf16_unet()
    print("| layer | shape | op by op: max err (ulps of peak) | equal | jitted: max err | equal |")
    print("|---|---|---|---|---|---|")
    for name in BF16_LAYERS:
        args, out = seen[name]
        fn, p = _jax_layer(jnet, params, name, args, out.shape[1] if out.ndim == 4 else None)
        got = _nhwc_np(out) if name != "unet" else out.float().numpy()
        cells = []
        for run in (fn, jax.jit(fn)):
            want = np.asarray(run(p), np.float32)
            d = np.abs(got - want)
            cells += [f"{d.max() / 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7):.2f}", f"{(d == 0).mean():.4f}"]
        print(f"| {name} | {tuple(got.shape)} | " + " | ".join(cells) + " |")
