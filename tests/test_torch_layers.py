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
    """Every module of vface_torch imports with jax, flax and vface_tpu blocked,
    and chip_smoke.py names none of them in an import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'vface_tpu'): sys.modules[m] = None\n"
        "import vface_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vface_torch.__path__, 'vface_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
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
