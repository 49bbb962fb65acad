"""The port's mesh (``vface_torch/parallel/mesh.py``) against the JAX package's.

The port runs one process per rank over gloo on the CPU (``tests/_torch_dist.py``);
JAX runs ``shard_map`` on its virtual CPU devices. Three ranks, so that a
middle rank (with a left and a right neighbour) is checked. Inputs are
seeded numpy; the halo, ``pmean``, ``align_by_flow_sharded`` and the
``flow_axis`` form of ``fuse_qkv`` are held to JAX's within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from _torch_dist import run_ranks
from _torch_port import close, t
from vface_tpu.ops import attention as JA
from vface_tpu.parallel import mesh as JM
from vface_torch.ops import attention as TA
from vface_torch.parallel import mesh as TM
from vface_torch.parallel.frame_sharded import padded_flow_layout

N_RANKS, F_LOCAL, H, W, C = 3, 2, 8, 8, 4
F = N_RANKS * F_LOCAL
TOK, D = 64, 8  # fuse_qkv: an 8 x 8 token grid


def _inputs():
    r = np.random.default_rng(5)
    x = r.normal(size=(F, H, W, C)).astype(np.float32)
    flow = (r.normal(size=(F - 1, H, W, 2)) * 1.5).astype(np.float32)
    pm = np.ones((F - 1,), np.float32)
    pm[2] = 0.0  # a window boundary inside the middle rank
    flow_pad, pm_pad = padded_flow_layout(t(flow), t(pm))
    q, k, v = (r.normal(size=(3, F, TOK, D)).astype(np.float32) for _ in range(3))
    return dict(frames=torch.arange(F, dtype=torch.float32).reshape(F, 1) * 1.5 + 0.25, x=t(x), flow=flow, pm=pm,
                flow_pad=flow_pad, pm_pad=pm_pad, q=q, k=k, v=v)


def _jax_sharded(fn, *args, specs=None):
    mesh = JM.make_mesh(n_data=N_RANKS)
    specs = specs or tuple(P("data") for _ in args)
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P("data"), check_rep=False)(*args))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x = _inputs()
    ins = {k: v for k, v in x.items() if isinstance(v, torch.Tensor)}
    ins.update(qkv={k: t(x[k]) for k in "qkv"})
    return x, run_ranks("halo_pmean_align", N_RANKS, ins, tmp_path_factory.mktemp("mesh"))


def test_halo_matches_jax(ranks):
    """Rank r gets rank r-1's last frame; rank 0 its own first."""
    x, outs = ranks
    want = _jax_sharded(lambda xs: JM.frame_halo_exchange(xs, "data")[None], jnp.asarray(x["frames"].numpy()))
    got = np.stack([o["halo"].numpy() for o in outs])
    close(got, want, atol=1e-6)
    assert got[:, 0].tolist() == [0.25, 1.75, 4.75]  # frames 0, 1 and 3


def test_pmean_matches_jax(ranks):
    x, outs = ranks
    want = _jax_sharded(lambda xs: JM.pmean(jnp.sum(xs))[None], jnp.asarray(x["frames"].numpy()))
    for o, w in zip(outs, want):
        close(o["pmean"], w, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_align_by_flow_sharded_matches_jax(ranks, masked):
    """The halo blend on the left-padded layout, with and without a zeroed pair
    inside a rank; also the unsharded blend of the same frames."""
    from vface_torch.ops.warp import align_by_flow

    x, outs = ranks
    args = [jnp.asarray(x["x"].numpy()), jnp.asarray(x["flow_pad"].numpy())]
    if masked:
        args.append(jnp.asarray(x["pm_pad"].numpy()))
        fn = lambda xs, fs, ms: JM.align_by_flow_sharded(xs, fs, alpha=0.8, pair_mask=ms)
    else:
        fn = lambda xs, fs: JM.align_by_flow_sharded(xs, fs, alpha=0.8)
    want = _jax_sharded(fn, *args)
    got = torch.cat([o["align_masked" if masked else "align"] for o in outs])
    close(got, want, atol=1e-6)
    plain = align_by_flow(x["x"], t(x["flow"]), 0.8, pair_mask=t(x["pm"]) if masked else None)
    close(got, plain.numpy(), atol=1e-6)


@pytest.mark.parametrize("chunks", [2, 3])
def test_fuse_qkv_flow_axis_matches_jax(ranks, chunks):
    """``fuse_qkv`` in ``flow_fix`` with ``flow_axis``: each rank's frames of
    every chunk, the channel-concatenated q||k warp over the halo; JAX's
    inside ``shard_map`` (2 chunks: the recon-free ``two_chunk_replace=False``)."""
    x, outs = ranks
    cfg = dict(mode="flow_fix", flow_tokens=TOK, use_circulant=False, two_chunk_replace=chunks == 3)
    qc, kc, vc = (x[k][:chunks] for k in "qkv")
    flow_pad = jnp.asarray(x["flow_pad"].numpy())  # the 8 x 8 token grid
    jcfg = JA.FusionConfig(**cfg, flow_axis="data")

    def local(q, k, v, fl, pm):
        f = q.shape[1]
        qo, ko, vo, carry = JA.fuse_qkv(q.reshape(chunks * f, TOK, D), k.reshape(chunks * f, TOK, D),
                                        v.reshape(chunks * f, TOK, D), jcfg, chunks=chunks, flow=fl, pair_mask=pm)
        assert carry is None
        return jnp.stack([qo, ko, vo])[None]

    mesh = JM.make_mesh(n_data=N_RANKS)
    spec = P(None, "data")
    want = np.asarray(shard_map(local, mesh=mesh, in_specs=(spec, spec, spec, P("data"), P("data")),
                                out_specs=P("data"), check_rep=False)(
        jnp.asarray(qc), jnp.asarray(kc), jnp.asarray(vc), flow_pad, jnp.asarray(np.asarray(x["pm_pad"]))))
    got = np.stack([o[f"fuse_{chunks}"].numpy() for o in outs])
    close(got, want, atol=1e-6)


def test_flow_axis_refuses_the_two_chunk_donor_copy():
    """As JAX's: with 2 chunks the donor copy would discard the halo blend."""
    cfg = dict(mode="flow_fix", flow_tokens=TOK, flow_axis="data")
    q = np.zeros((2 * F_LOCAL, TOK, D), np.float32)
    flow = np.zeros((F_LOCAL, H, W, 2), np.float32)
    with pytest.raises(ValueError, match="two_chunk_replace") as jerr:
        JA.fuse_qkv(q, q, q, JA.FusionConfig(**cfg), chunks=2, flow=flow)
    with TM.bind_axis("data", TM.single_device_mesh("cpu")):
        with pytest.raises(ValueError, match="two_chunk_replace") as terr:
            TA.fuse_qkv(t(q), t(q), t(q), TA.FusionConfig(**cfg), chunks=2, flow=t(flow))
    assert str(terr.value) == str(jerr.value)
    # the config stays hashable with its axis name
    assert hash(dataclasses.replace(TA.FusionConfig(), flow_axis="data")) is not None


def test_make_mesh_one_rank_and_refusals(monkeypatch):
    """Without torchrun's environment one rank and no group; a data axis other
    than the world size names torchrun; no model axis."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = TM.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.shape) == (0, 1, None, {"data": 1, "model": 1})
    assert TM.axis_mesh("data") is mesh
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        TM.make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="n_model"):
        TM.make_mesh(n_model=2, device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(TM.shard_batch(mesh, {"a": x})["a"], x)
    assert torch.equal(TM.frame_halo_exchange(x, mesh), x[0])
    assert torch.equal(TM.pmean({"a": x}, mesh)["a"], x)
    with pytest.raises(ValueError, match="divide"):
        TM.shard_rows(dataclasses.replace(mesh, size=4), 6)
    assert TM.shard_rows(dataclasses.replace(mesh, size=3, rank=1), 6) == slice(2, 4)
    TM.destroy()
