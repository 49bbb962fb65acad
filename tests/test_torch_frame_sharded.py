"""Frame-sharded hooked sampling (``vface_torch/parallel/frame_sharded.py``) against the JAX package's.

The tiny bundle (``ModelConfig.tiny(image_size=32)``, seeded numpy params: no
JAX init is compiled), fp32 on the CPU. A window of 4 frames over 2 gloo
ranks (2 frames each, so the FGATS blend crosses the rank boundary through
the halo), 2 sampling steps, FGATS at the latent's token count. JAX runs its
``vface_sample_frame_sharded`` under ``shard_map`` on 2 of its virtual CPU
devices. Held: each rank's frames within 1e-4 of JAX's (fp32 round-off over
two UNet evals at CFG 3, as the port's sampler against JAX's,
``tests/test_torch_samplers.py``) and within 2e-5 of the port's unsharded
sampler (the JAX package's limit for its own sharded sampler,
``tests/test_parallel.py``), with and without a zeroed pair-mask entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_port import close, np_tree, seeded_bundle_params, t
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FusionConfig
from vface_torch.parallel import mesh as TM
from vface_torch.parallel.frame_sharded import padded_flow_layout, vface_sample_frame_sharded
from vface_torch.samplers.vface import vface_sample
from vface_torch.utils.convert import from_flax_params

RANKS, F = 2, 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from vface_tpu.models import ModelConfig as JConfig
    from vface_tpu.models import VFaceModel as JModel

    jm = JModel(JConfig.tiny(image_size=32))
    params = seeded_bundle_params(jm, seed=17)
    hl, d = jm.cfg.latent_size, jm.cfg.unet.context_dim
    r = np.random.default_rng(18)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    args = dict(x_T=n(F, hl, hl, 4), cond=n(F, 1, d), uncond=n(F, 1, d), inpaint=n(F, hl, hl, 4, scale=0.1),
                mask=r.uniform(size=(F, hl, hl, 1)).astype(np.float32), flow=n(F - 1, hl, hl, 2, scale=1.2))
    pm = np.ones((F - 1,), np.float32)
    pm[0] = 0.0  # a window boundary inside rank 0: the pair mask crosses the halo's layout
    state = from_flax_params(np_tree({"unet": params["unet"], "vae": params["vae"]}))
    ins = dict(state=state, tokens=hl * hl, args={k: t(v) for k, v in args.items()}, pair_mask=t(pm))
    outs = run_ranks("frame_sharded_sample", RANKS, ins, tmp_path_factory.mktemp("fs"))
    return dict(jm=jm, params=params, args=args, pm=pm, tokens=hl * hl, state=state, outs=outs)


def _jax(setup, pm):
    from vface_tpu.models import InjectionSpec as JSpec
    from vface_tpu.ops.attention import FusionConfig as JFusion
    from vface_tpu.parallel.frame_sharded import vface_sample_frame_sharded as jfs
    from vface_tpu.parallel.mesh import make_mesh

    a = {k: jnp.asarray(v) for k, v in setup["args"].items()}
    spec = JSpec(input_blocks=JFusion("flow_fix", flow_tokens=setup["tokens"]), chunks=3)
    return np.asarray(jfs(setup["jm"], setup["params"], a["x_T"], a["cond"], a["uncond"], a["cond"], a["inpaint"],
                          a["mask"], spec, flow=a["flow"], mesh=make_mesh(n_data=RANKS), num_steps=2,
                          flow_pair_mask=None if pm is None else jnp.asarray(pm)))


def _port_unsharded(setup, pm):
    from _torch_dist import _tiny_model

    model = _tiny_model(setup["state"])
    a = {k: t(v) for k, v in setup["args"].items()}
    spec = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=setup["tokens"]), chunks=3)
    with torch.inference_mode():
        return vface_sample(model, a["x_T"], a["cond"], a["uncond"], a["cond"], None, a["inpaint"], a["mask"], spec,
                            flow=a["flow"], num_steps=2, drop_recon_chunk=True,
                            flow_pair_mask=None if pm is None else t(pm))[0]


@pytest.mark.parametrize("masked", [False, True])
def test_frame_sharded_sampling_matches_jax_and_the_unsharded_sampler(setup, masked):
    pm = setup["pm"] if masked else None
    got = torch.cat([o["masked" if masked else "plain"] for o in setup["outs"]])
    want = _jax(setup, pm)
    peak = float(np.abs(want).max())
    close(got, want, atol=1e-4 * max(peak, 1.0))
    close(got, _port_unsharded(setup, pm).numpy(), atol=2e-5 * max(peak, 1.0))


def test_padded_flow_layout():
    """(F-1,) pairs -> (F,) per-frame slots: slot 0 dead (mask 0), slot i = pair (i-1, i)."""
    flow = torch.zeros((F - 1, 4, 4, 2))
    flow_pad, pm_pad = padded_flow_layout(flow, torch.tensor([1.0, 0.0, 1.0]))
    assert flow_pad.shape == (F, 4, 4, 2)
    assert pm_pad.tolist() == [0.0, 1.0, 0.0, 1.0]


def test_refusals_match_jax(setup):
    """JAX's ValueErrors: frames that do not divide over the ranks, no flow.
    The port's rank takes its own frames and the window's flow (F - 1 pairs)."""
    from vface_tpu.parallel.frame_sharded import vface_sample_frame_sharded as jfs
    from vface_tpu.parallel.mesh import make_mesh

    mesh2 = TM.Mesh(rank=0, size=RANKS, device=torch.device("cpu"))
    a = {k: t(v) for k, v in setup["args"].items()}
    ja = {k: jnp.asarray(v) for k, v in setup["args"].items()}
    spec = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=setup["tokens"]))
    for frames, flow, match in ((3, "flow", "must divide"), (4, None, "pass flow")):
        own = slice(0, 2)  # rank 0's rows
        with pytest.raises(ValueError, match=match) as terr:
            vface_sample_frame_sharded(None, a["x_T"][own], a["cond"][own], a["uncond"][own], a["cond"][own],
                                       a["inpaint"][own], a["mask"][own], spec,
                                       flow=None if flow is None else a["flow"][:frames - 1], mesh=mesh2)
        rows = slice(0, frames)
        with pytest.raises(ValueError, match=match) as jerr:
            jfs(setup["jm"], setup["params"], ja["x_T"][rows], ja["cond"][rows], ja["uncond"][rows],
                ja["cond"][rows], ja["inpaint"][rows], ja["mask"][rows], None,
                flow=None if flow is None else ja["flow"][:frames - 1], mesh=make_mesh(n_data=RANKS))
        assert str(terr.value) == str(jerr.value)
