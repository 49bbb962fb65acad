"""The rest of the UNet and the conditioner against the JAX package's: the TSG
conv injection, the dual 2x768 context (``head_splits``), the "concat",
"stack" and "sep_head" token modes and ``EncoderUNetModel``.

Tiny configs (``ModelConfig.tiny(image_size=32)``: context 64, 4 heads) with
seeded params that hold no zero convolution, fp32 on the CPU; the port loads
JAX's trees through ``from_flax_params`` / ``flax_tree_to_state_dict``.

Limits: one UNet eval or one attention call within 1e-5 (fp32 round-off);
the conditioner's tokens, and a UNet eval on them, within 1e-5 of the
output's peak (the landmark tokens are hundreds wide at 32^2 pixel
coordinates), as ``test_torch_cond.py`` holds the "sum" token; a sampler's
latents within 1e-4 (CFG amplifies each eps difference by its scale), as the
other sampler tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, port_model, seeded_bundle_params, seeded_flax_params, t
from vface_torch.models.unet import CrossAttention, EncoderUNetModel, InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.samplers.vface import vface_sample, vface_sample_pipelined
from vface_torch.utils.convert import flax_tree_to_state_dict

F, HL, D, S = 2, 8, 64, 4  # frames per chunk, latent side, context width, sampler steps (a divisor of 1000)
MODES = ("concat", "stack", "sep_head")


@pytest.fixture(scope="module")
def bundle():
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel

    jm = JModel(JConfig.tiny(image_size=32))
    params = seeded_bundle_params(jm, seed=31)
    r = np.random.default_rng(32)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    data = dict(x9=n(3 * F, HL, HL, 9), ctx=n(3 * F, 1, D), x_T=n(F, HL, HL, 4), cond=n(F, 1, D),
                uncond=n(F, 1, D), tcond=n(F, 1, D), inv=n(S, F, HL, HL, 4), inpaint=n(F, HL, HL, 4),
                mask=(r.uniform(size=(F, HL, HL, 1)) > 0.5).astype(np.float32),
                flow=n(F - 1, HL, HL, 2, scale=1.5))
    return dict(jm=jm, params=params, model=port_model(params), d=data)


def _injections(conv_inject: bool, fusion: str = "none"):
    from vface_tpu.models.unet import InjectionSpec as JInjectionSpec
    from vface_tpu.ops.attention import FusionConfig as JFusionConfig

    return (JInjectionSpec(input_blocks=JFusionConfig(fusion, flow_tokens=HL * HL), chunks=3,
                           conv_inject=conv_inject),
            InjectionSpec(input_blocks=FusionConfig(fusion, flow_tokens=HL * HL), chunks=3, conv_inject=conv_inject))


@pytest.mark.parametrize("fusion", ["none", "flow_fix"])
def test_conv_inject_matches_jax(bundle, fusion):
    """A 3-chunk eval with the conv injection (and FSAI + FGATS at the input
    blocks): within 1e-5 of JAX's; the injection moves chunks 0 and 1 and
    leaves chunk 2, the donor, as it was."""
    d = bundle["d"]
    ts = np.full((3 * F,), 400, np.int32)
    flow = d["flow"] if fusion != "none" else None
    jinj, inj = _injections(True, fusion)
    want = bundle["jm"].apply_model(bundle["params"], jnp.asarray(d["x9"]), jnp.asarray(ts), jnp.asarray(d["ctx"]),
                                    flow=None if flow is None else jnp.asarray(flow), injection=jinj)
    fl = None if flow is None else t(flow)
    with torch.inference_mode():
        got = bundle["model"].apply_model(t(d["x9"]), t(ts).long(), t(d["ctx"]), flow=fl, injection=inj)
        plain = bundle["model"].apply_model(t(d["x9"]), t(ts).long(), t(d["ctx"]), flow=fl,
                                            injection=_injections(False, fusion)[1])
    close(got, np.asarray(want), atol=1e-5)
    assert float((got[:2 * F] - plain[:2 * F]).abs().max()) > 1e-3
    close(got[2 * F:], plain[2 * F:].numpy(), atol=1e-6)


@pytest.mark.parametrize("drop", [False, True], ids=["recon", "recon_free"])
def test_vface_sample_with_conv_inject_matches_jax(bundle, drop):
    """``vface_sample`` (4 steps, CFG 3, FSAI + FGATS) with the conv injection
    passed through, on the 3-chunk and the recon-free batch: z_0 and the
    trajectory within 1e-4 of JAX's."""
    from vface_tpu.samplers.vface import vface_sample as jax_vface_sample

    d = bundle["d"]
    jinj, inj = _injections(True, "flow_fix")
    args = [d[k] for k in ("x_T", "cond", "uncond", "tcond", "inv", "inpaint", "mask")]
    common = dict(num_steps=S, cfg_scale=3.0, drop_recon_chunk=drop)
    wz, wtraj = jax_vface_sample(bundle["jm"], bundle["params"], *map(jnp.asarray, args), jinj,
                                 flow=jnp.asarray(d["flow"]), **common)
    with torch.inference_mode():
        z, traj = vface_sample(bundle["model"], *map(t, args), inj, flow=t(d["flow"]), **common)
    close(z, np.asarray(wz), atol=1e-4)
    close(traj, np.asarray(wtraj), atol=1e-4)


def test_pipelined_packs_refuse_conv_inject(bundle):
    """``vface_sample_pipelined`` refuses the conv injection with a ValueError, as JAX's does."""
    from vface_tpu.samplers.vface import vface_sample_pipelined as jax_pipelined

    d = bundle["d"]
    jinj, inj = _injections(True, "flow_fix")
    nxt = dict(next_z0=d["x_T"], next_cond=d["cond"], next_inpaint=d["inpaint"], next_mask=d["mask"])
    args = [d[k] for k in ("x_T", "cond", "uncond", "inpaint", "mask")]
    with pytest.raises(ValueError, match="conv_inject"):
        jax_pipelined(bundle["jm"], bundle["params"], *map(jnp.asarray, args), jinj,
                      **{k: jnp.asarray(v) for k, v in nxt.items()}, num_steps=S, inversion_steps=S)
    with pytest.raises(ValueError, match="conv_inject"):
        vface_sample_pipelined(bundle["model"], *map(t, args), inj, **{k: t(v) for k, v in nxt.items()},
                               num_steps=S, inversion_steps=S)


def _rel(got, want, tol: float = 1e-5) -> None:
    """|got - want| <= tol * max|want|."""
    want = np.asarray(want, np.float32)
    close(got, want, atol=tol * float(np.abs(want).max()))


def _cond_inputs(seed: int, b: int = 2):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, 32, 32, 3)).astype(np.float32), (r.uniform(size=(b, 136)) * 32).astype(np.float32),
            r.normal(size=(b, 32, 32, 3)).astype(np.float32), r.uniform(size=(b, 112, 112, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def conditioners():
    """Per mode: the JAX conditioner, its seeded params and the port's conditioner loaded from them."""
    import dataclasses

    from vface_tpu.models.conditioning import Conditioner as JConditioner
    from vface_tpu.models.conditioning import ConditionerConfig as JCondConfig
    from vface_torch.models.conditioning import Conditioner, ConditionerConfig

    out = {}
    for i, mode in enumerate(MODES):
        jc = JConditioner(dataclasses.replace(JCondConfig.tiny(), mode=mode))
        params = seeded_flax_params(jc, *map(jnp.asarray, _cond_inputs(0, 1)), seed=40 + i)
        tc = Conditioner(dataclasses.replace(ConditionerConfig.tiny(), mode=mode))
        tc.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
        out[mode] = (jc, params, tc.eval())
    return out


@pytest.mark.parametrize("mode", MODES)
def test_conditioner_mode_matches_jax(conditioners, mode):
    """The conditioning tokens in each token mode within 1e-5 of JAX's at the
    peak, the uncond equal: (B, 1, 64) for "concat", (B, 3, 64) for "stack", (B, 1, 128) for
    "sep_head"; "concat" also without landmarks (zeros in their place)."""
    from vface_tpu.models.conditioning import Conditioner as JConditioner

    jc, params, tc = conditioners[mode]
    inputs = _cond_inputs(50)
    want = jc.apply({"params": params}, *map(jnp.asarray, inputs))
    want_u = jc.apply({"params": params}, 2, method=JConditioner.uncond)
    with torch.inference_mode():
        got, got_u = tc(*map(t, inputs)), tc.uncond(2)
    shape = {"concat": (2, 1, D), "stack": (2, 3, D), "sep_head": (2, 1, 2 * D)}[mode]
    assert tuple(got.shape) == tuple(got_u.shape) == shape
    _rel(got, want)
    close(got_u, np.asarray(want_u), atol=0)
    if mode == "concat":
        no_lm = (inputs[0], None, inputs[2], inputs[3])
        want = jc.apply({"params": params}, *(None if a is None else jnp.asarray(a) for a in no_lm))
        with torch.inference_mode():
            got = tc(*(None if a is None else t(a) for a in no_lm))
        _rel(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_unet_eval_in_each_mode_matches_jax(bundle, conditioners, mode):
    """The UNet (context_dim 64 in every mode) on the mode's cond and uncond as
    one CFG batch: "stack" through three-key cross-attention, "sep_head"
    through the dual context and the single-token shortcut; within 1e-5 of
    the output's peak."""
    from vface_tpu.models.conditioning import Conditioner as JConditioner

    jc, params, tc = conditioners[mode]
    inputs = _cond_inputs(51)
    ctx = np.concatenate([np.asarray(jc.apply({"params": params}, 2, method=JConditioner.uncond)),
                          np.asarray(jc.apply({"params": params}, *map(jnp.asarray, inputs)))])
    x9 = bundle["d"]["x9"][:4]
    ts = np.array([900, 600, 300, 10], np.int32)
    want = bundle["jm"].apply_model(bundle["params"], jnp.asarray(x9), jnp.asarray(ts), jnp.asarray(ctx))
    with torch.inference_mode():
        got = bundle["model"].apply_model(t(x9), t(ts).long(), t(ctx))
    _rel(got, want)


@pytest.mark.parametrize("splits", [None, (1, 3), (2, 2)], ids=["default", "1_3", "2_2"])
@pytest.mark.parametrize("tokens", [1, 3])
def test_dual_context_attention_matches_jax(splits, tokens):
    """Cross-attention on a 2 x 64 context: one token (the single-token
    shortcut, which must build the dual v) and three tokens (the attention
    path), at the default 3:1 split and with ``head_splits`` given; within
    1e-5 of JAX's. The split matters: c2 moves the output."""
    from vface_tpu.models.unet import CrossAttention as JCrossAttention

    r = np.random.default_rng(60 + tokens)
    x = r.normal(size=(2, 16, 32)).astype(np.float32)
    ctx = r.normal(size=(2, tokens, 2 * D)).astype(np.float32)
    jattn = JCrossAttention(32, D, heads=4, head_splits=splits)
    params = seeded_flax_params(jattn, jnp.asarray(x), jnp.asarray(ctx), seed=61)
    want = jattn.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    attn = CrossAttention(32, D, heads=4, head_splits=splits)
    attn.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    moved = ctx.copy()
    moved[..., D:] += 1.0
    with torch.inference_mode():
        got = attn(t(x), t(ctx))
        other = attn(t(x), t(moved))
    close(got, np.asarray(want), atol=1e-5)
    assert float((got - other).abs().max()) > 1e-3


def test_encoder_unet_matches_jax():
    """``EncoderUNetModel`` (the tiny UNet's input blocks and middle ResBlocks, a
    spatial mean and a 10-way head) within 1e-5 of JAX's."""
    from vface_tpu.models.unet import EncoderUNetModel as JEncoderUNetModel
    from vface_tpu.models.unet import UNetConfig as JUNetConfig
    from vface_torch.models.unet import UNetConfig

    r = np.random.default_rng(70)
    x = r.normal(size=(3, HL, HL, 9)).astype(np.float32)
    ts = np.array([999, 500, 1], np.int32)
    jenc = JEncoderUNetModel(JUNetConfig.tiny(), out_dim=10)
    params = seeded_flax_params(jenc, jnp.asarray(x), jnp.asarray(ts), seed=71)
    want = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts))
    enc = EncoderUNetModel(UNetConfig.tiny(), out_dim=10)
    enc.load_state_dict(flax_tree_to_state_dict(np_tree(params)))
    with torch.inference_mode():
        got = enc(t(x), t(ts).long())
    assert tuple(got.shape) == (3, 10) and got.dtype == torch.float32
    close(got, np.asarray(want), atol=1e-5)


def test_init_params_builds_each_mode():
    """``init_params`` seeds the mode's extra parameters, a model of each mode
    loads them strictly, and the UNet's and the VAE's draws do not depend on
    the mode."""
    import dataclasses

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import init_params

    base = ModelConfig.tiny()
    for mode in ("sum",) + MODES:
        cfg = dataclasses.replace(base, cond=dataclasses.replace(base.cond, mode=mode))
        state = init_params(cfg, torch.Generator().manual_seed(3), conditioner=True)
        model = VFaceModel(cfg, device="cpu", conditioner=True)
        model.load_params(state)
        extra = {"concat": "concat_feat_proj.weight", "stack": "other_learnable_vector"}.get(mode)
        if extra:
            assert float(state["cond"][extra].abs().sum()) > 0
        if mode == "sum":
            ref = state
        else:
            for part in ("unet", "vae"):
                assert all(torch.equal(ref[part][k], state[part][k]) for k in ref[part])
