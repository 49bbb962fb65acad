"""The port's SD-v1-inpaint UNet against the JAX package's at full widths, and
both checkpoint converters on a full-size LDM state dict (``slow``: tier-1
leaves it out).

The analogue of ``tests/test_flagship_parity.py`` with the port in the
reference's place: ``UNetConfig.sd_v1_inpaint`` widths (320 model channels,
channel_mult (1, 2, 4, 4), 8 heads, 768-d context) at fp32 on the CPU, one set
of seeded weights (``tests/_torch_port.py::seeded_tree``), the literal
3-chunk [uncond, cond, recon] batch of 2 frames a chunk on a 32^2 latent with
FSAI (``flow_fix``) and FGATS on at ds1, held at 1e-4 of the epsilon's peak.
Then the LDM state dict of the same UNet and the SD VAE (made by inverting
JAX's converters, as ``tests/test_torch_convert.py`` does): the port's trees
bit-equal to JAX's, and ``strict=True`` loads into the port's modules.

Several minutes of CPU and ~15 GB of memory:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flagship_parity.py -m slow -q
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, seeded_tree, t

pytestmark = pytest.mark.slow


def unet_parity(jcfg, tcfg, side: int = 32, frames: int = 2, seed: int = 0) -> float:
    """The port's UNet at ``tcfg`` against JAX's at ``jcfg`` on one seeded tree:
    3 chunks of ``frames``, FSAI ``flow_fix`` at ds1; returns the largest
    distance over the epsilon's peak."""
    from vface_tpu.models.unet import InjectionSpec as JIS
    from vface_tpu.models.unet import UNetModel as JUNet
    from vface_tpu.ops.attention import FusionConfig as JFC
    from vface_torch.models.unet import InjectionSpec, UNetModel
    from vface_torch.ops.attention import FusionConfig
    from vface_torch.utils.convert import flax_tree_to_state_dict

    rng = np.random.default_rng(seed)
    b = 3 * frames
    x = rng.normal(size=(b, side, side, 9)).astype(np.float32)
    ts = np.full((b,), 961, np.int32)
    ctx = rng.normal(size=(b, 1, jcfg.context_dim)).astype(np.float32)
    flow = (rng.normal(size=(frames - 1, side, side, 2)) * 2).astype(np.float32)
    jnet = JUNet(jcfg)
    shapes = jax.eval_shape(lambda r: jnet.init(r, jnp.asarray(x[:1]), jnp.asarray(ts[:1]),
                                                jnp.asarray(ctx[:1]))["params"], jax.random.PRNGKey(0))
    params = np_tree(seeded_tree(shapes, seed + 1))
    fc = dict(flow_tokens=side * side, two_chunk_replace=True)
    want = np.asarray(jax.jit(lambda p: jnet.apply({"params": p}, x, ts, ctx, flow=flow,
                                                   injection=JIS(input_blocks=JFC("flow_fix", **fc), chunks=3)))(params))
    net = UNetModel(tcfg)
    net.load_state_dict(flax_tree_to_state_dict(params), strict=True)
    del params
    with torch.no_grad():
        got = net(t(x), t(ts).long(), t(ctx), flow=t(flow),
                  injection=InjectionSpec(input_blocks=FusionConfig("flow_fix", **fc), chunks=3)).numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_full_width_unet_matches_jax():
    from vface_tpu.models.unet import UNetConfig as JCfg
    from vface_torch.models.unet import UNetConfig

    jcfg = JCfg.sd_v1_inpaint(dtype=jnp.float32, use_flash=False)
    jcfg = dataclasses.replace(jcfg, use_remat=False, use_fused_ff=False)
    tcfg = dataclasses.replace(UNetConfig.sd_v1_inpaint(dtype=torch.float32), use_remat=False)
    assert (tcfg.model_channels, tcfg.channel_mult, tcfg.num_heads, tcfg.context_dim) == (320, (1, 2, 4, 4), 8, 768)
    assert unet_parity(jcfg, tcfg) <= 1e-4


def test_full_size_ldm_state_dict_converts_as_jax_and_loads_strictly():
    from test_torch_convert import _equal_trees, invert
    from vface_tpu.models import ModelConfig as JModelConfig
    from vface_tpu.models import VFaceModel as JModel
    from vface_tpu.utils import sd_convert as JSD
    from vface_tpu.utils.torch_convert import verify_tree
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils import sd_convert as TSD

    jm = JModel(JModelConfig.sd_v1_inpaint(dtype=jnp.float32))
    tree = np_tree(seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 2))
    tcfg = ModelConfig.sd_v1_inpaint(dtype=torch.float32)
    sd_u, want_u = invert(lambda sd: JSD.convert_sd_unet(sd, jm.cfg.unet), tree["unet"])
    sd_v, want_v = invert(lambda sd: JSD.convert_sd_vae(sd, jm.cfg.vae), tree["vae"])
    _equal_trees(JSD.convert_sd_unet(sd_u, jm.cfg.unet), want_u)
    _equal_trees(JSD.convert_sd_vae(sd_v, jm.cfg.vae), want_v)
    _equal_trees(TSD.convert_sd_unet(sd_u, tcfg.unet), want_u)
    _equal_trees(TSD.convert_sd_vae(sd_v, tcfg.vae), want_v)
    assert verify_tree(TSD.convert_sd_unet(sd_u, tcfg.unet), tree["unet"]) == []
    del tree, want_u, want_v
    model = VFaceModel(tcfg, device="cpu")
    model.load_params(TSD.model_state_dicts({**sd_u, **sd_v}, tcfg))
    k = sd_u["model.diffusion_model.input_blocks.0.0.weight"]
    assert tuple(k.shape) == (320, 9, 3, 3)
    close(model.unet.conv_in.weight, k.numpy(), atol=0.0)
