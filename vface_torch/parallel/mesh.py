"""The mesh and its collectives: the port's multi-GPU backbone (torch.distributed).

Port of ``vface_tpu/parallel/mesh.py``. JAX's mesh is single-controller: one
program sees every device. Here a mesh is one process per rank (``torchrun``
starts them), and its ``data`` axis is a process group:

* :func:`make_mesh` forms the group from torchrun's ``RANK`` / ``WORLD_SIZE``
  / ``LOCAL_RANK`` (or the caller's rank and size), or, with no such
  environment, one rank without a group. Each rank's device is
  ``cuda:LOCAL_RANK`` unless the caller names one. The backend is explicit:
  NCCL for CUDA, gloo for the CPU, or the caller's choice; nothing retries
  another backend;
* :func:`shard_batch` / :func:`replicate`: a rank's rows of the leading
  axis, and the whole;
* :func:`frame_halo_exchange`: the left neighbour's last frame, one
  point-to-point pair per rank (rank 0 gets its own first frame);
* :func:`pmean`, :func:`all_gather_rows`, :func:`align_by_flow_sharded`;
* :func:`zero1`: the ZeRO-1 shard of the AdamW moments
  (``ZeroRedundancyOptimizer`` over ``torch.optim.AdamW``; each rank keeps
  the moments of its share of the parameters).

Gloo takes CUDA tensors for broadcast and all-reduce only. Under a gloo
group, the helpers here run the other collectives on a CUDA tensor (the
halo's send and receive, the all-gather) through host memory. That is the
case of two ranks sharing one card, where NCCL refuses the second rank.

A name such as ``"data"`` resolves to its mesh through :func:`axis_mesh`,
so that a frozen, hashable ``FusionConfig.flow_axis`` can name the axis
its halo runs over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

BATCH = "data"  # the leading (frame / batch) axis is sharded over the data axis
REPLICATED = None

_AXES: Dict[str, "Mesh"] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (data, model) mesh; ``group`` is None for one rank."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

    @property
    def staged(self) -> bool:
        """Whether collectives gloo refuses on CUDA go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, backend: Optional[str] = None, device="cuda",
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """The ``data`` axis over this process's ranks.

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` / ``WORLD_SIZE``;
    without either there is one rank and no process group. ``device`` "cuda"
    is ``cuda:LOCAL_RANK``; a device with an index (``"cuda:0"``) or "cpu" is
    taken as it is. ``backend`` defaults to NCCL on CUDA and gloo on the CPU.
    ``init_method`` defaults to ``env://`` (torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``); a group is formed for more than one rank, under torchrun
    or with an ``init_method``. A group that is already initialised is used as it is.
    ``n_data`` (None: every rank) must equal the world size; ``n_model`` is 1,
    as for every caller of the JAX package. The mesh is registered under
    ``axis_name`` (see :func:`axis_mesh`)."""
    if n_model != 1:
        raise ValueError(f"make_mesh: n_model={n_model}; the port's mesh has a data axis only")
    if dist.is_available() and dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = _env_int("RANK") if rank is None else rank
        world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
        rank, world_size = rank or 0, world_size or 1
    if n_data is not None and n_data != world_size:
        raise ValueError(f"make_mesh: n_data={n_data} but the world has {world_size} rank(s); "
                         f"start one process per rank, e.g. torchrun --nproc_per_node {n_data}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("vface_torch: CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(dev)
    group = None
    if world_size > 1 or _env_int("WORLD_SIZE") is not None or init_method is not None:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if not dist.is_initialized():
            kw = dict(device_id=dev) if backend == "nccl" else {}
            dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                    world_size=world_size, **kw)
        group = dist.group.WORLD
        backend = dist.get_backend(group)
    mesh = Mesh(rank=rank, size=world_size, device=dev, backend=backend, group=group)
    _AXES[axis_name] = mesh
    return mesh


def single_device_mesh(device="cuda") -> Mesh:
    """One rank, no process group."""
    dev = torch.device(device)
    return Mesh(rank=0, size=1, device=dev)


def axis_mesh(axis_name: str) -> Mesh:
    """The mesh registered under ``axis_name`` (by :func:`make_mesh` or :func:`bind_axis`)."""
    if axis_name not in _AXES:
        raise ValueError(f"no mesh is bound to the axis {axis_name!r}: call make_mesh first")
    return _AXES[axis_name]


@contextlib.contextmanager
def bind_axis(axis_name: str, mesh: Mesh):
    """Resolve ``axis_name`` to ``mesh`` inside the block."""
    old = _AXES.get(axis_name)
    _AXES[axis_name] = mesh
    try:
        yield mesh
    finally:
        if old is None:
            _AXES.pop(axis_name, None)
        else:
            _AXES[axis_name] = old


def destroy() -> None:
    """End the process group (if any) and forget every bound axis."""
    _AXES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------ sharding
def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of ``n`` (which the mesh size divides)."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over {mesh.size} rank(s)")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """A pytree (dict / list / tuple) of arrays or tensors -> this rank's rows of
    each leaf's leading axis, tensors on the mesh's device."""

    def leaf(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return x[shard_rows(mesh, x.shape[0])].to(mesh.device)

    return _tree_map(leaf, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf whole, as tensors on the mesh's device."""
    return _tree_map(lambda x: (x if isinstance(x, torch.Tensor) else torch.as_tensor(x)).to(mesh.device), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


# --------------------------------------------------------------- collectives
def _host(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if mesh.staged else x


def frame_halo_exchange(x: torch.Tensor, axis_name="data") -> torch.Tensor:
    """The frame before this shard's first: the left neighbour's last frame of
    ``x`` (f_local, ...), fetched by one point-to-point pair per rank (rank r
    sends its last frame to r + 1 and receives r - 1's). Rank 0 has no left
    neighbour and gets its own first frame (the blend is the identity there).
    ``axis_name`` is a bound axis name or a :class:`Mesh`."""
    mesh = axis_name if isinstance(axis_name, Mesh) else axis_mesh(axis_name)
    if mesh.size == 1:
        return x[0]
    send = _host(mesh, x[-1].contiguous())
    recv = torch.empty_like(send)
    ops = []
    if mesh.rank + 1 < mesh.size:
        ops.append(dist.P2POp(dist.isend, send, mesh.rank + 1, mesh.group))
    if mesh.rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank - 1, mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return x[0] if mesh.rank == 0 else recv.to(x.device)


def pmean(tree, axis_name="data"):
    """Every tensor of ``tree`` averaged over the ranks (a sum all-reduce over the size)."""
    mesh = axis_name if isinstance(axis_name, Mesh) else axis_mesh(axis_name)

    def leaf(a):
        if mesh.size == 1:
            return a
        out = a.detach().clone()
        dist.all_reduce(out, group=mesh.group)
        return out / mesh.size

    return _tree_map(leaf, tree)


def all_gather_rows(x: torch.Tensor, axis_name="data") -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis, in rank order."""
    mesh = axis_name if isinstance(axis_name, Mesh) else axis_mesh(axis_name)
    if mesh.size == 1:
        return x
    h = _host(mesh, x.contiguous())
    parts = [torch.empty_like(h) for _ in range(mesh.size)]
    dist.all_gather(parts, h, group=mesh.group)
    return torch.cat(parts).to(x.device)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh, bucket_elems: int = 1 << 26) -> None:
    """Average ``.grad`` of ``params`` over the ranks in place, in flat buckets
    of at most ``bucket_elems`` elements per dtype. A parameter without a
    gradient keeps none, as the one-rank step leaves it (AdamW then skips
    it): every rank runs the same graph, so the same parameters have one."""
    if mesh.size == 1:
        return
    params = [p for p in params if p.grad is not None]
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        i = 0
        while i < len(group):
            bucket, n = [], 0
            while i < len(group) and (not bucket or n + group[i].numel() <= bucket_elems):
                bucket.append(group[i])
                n += group[i].numel()
                i += 1
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            dist.all_reduce(flat, group=mesh.group)
            flat /= mesh.size
            off = 0
            for p in bucket:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()


def align_by_flow_sharded(x: torch.Tensor, flow: torch.Tensor, alpha: float = 0.8, axis_name="data",
                          pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FGATS blend with frames sharded over ``axis_name``: the parallel
    layer's name for :func:`vface_torch.ops.warp.align_by_flow_halo` (the
    left-padded per-frame flow layout, the halo from the left neighbour)."""
    from vface_torch.ops.warp import align_by_flow_halo

    return align_by_flow_halo(x, flow, alpha, pair_mask, axis_name)


# -------------------------------------------------------------------- ZeRO-1
def zero1(params, mesh: Mesh, **adamw_kwargs) -> torch.optim.Optimizer:
    """AdamW over ``params`` with its moments sharded over the ranks (ZeRO-1):
    each rank steps the AdamW of its share of the parameters and broadcasts
    them. One rank: a plain ``torch.optim.AdamW``. Gradients must already be
    averaged (:func:`all_reduce_grads`). ``optimizer_state_one_device`` gives
    the gathered state in the one-device layout."""
    params = list(params)
    if mesh.size == 1:
        return torch.optim.AdamW(params, **adamw_kwargs)
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.AdamW, process_group=mesh.group,
                                   **adamw_kwargs)


def optimizer_state_one_device(optimizer: torch.optim.Optimizer, mesh: Mesh) -> Optional[dict]:
    """The optimizer's state dict in the layout of one AdamW over the same
    parameter list: on rank 0 the ZeRO-1 shards gathered (a collective: every
    rank calls it), None on the other ranks. Each parameter's moments are
    broadcast as tensors from the rank that owns them, which keeps the
    gather at the link's rate (``ZeroRedundancyOptimizer.consolidate_state_dict``
    pickles every shard: 268-282 s for the SD-v1 trainable set over gloo on
    an H100 80GB HBM3 at 700 W, ``chip_smoke.py`` phase mesh_train)."""
    if mesh.size == 1 or not hasattr(optimizer, "optim"):
        return optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    owner = {p: r for r, groups in enumerate(optimizer._partition_parameters())
             for group in groups for p in group["params"]}
    local = optimizer.optim.state
    state = {}
    for i, p in enumerate(params):
        src = owner[p]
        mine = local.get(p) if src == mesh.rank else None
        step = torch.tensor([float(mine["step"]) if mine else -1.0], device=mesh.device)
        dist.broadcast(step, src, group=mesh.group)
        if step.item() < 0:  # never stepped: no state, as one AdamW keeps none
            continue
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            t = mine[key].contiguous() if mine else torch.empty_like(p, memory_format=torch.contiguous_format)
            dist.broadcast(t, src, group=mesh.group)
            moments[key] = t
        if mesh.rank == 0:
            state[i] = {"step": torch.tensor(step.item()), **moments}
    if mesh.rank != 0:
        return None
    hyper = {k: v for k, v in optimizer.optim.param_groups[0].items() if k != "params"}
    hyper.update({k: v for k, v in optimizer.param_groups[0].items() if k != "params"})  # lr, initial_lr
    return {"state": state, "param_groups": [{**hyper, "params": list(range(len(params)))}]}


def local_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of optimizer state (the AdamW moments) this rank holds."""
    opt = getattr(optimizer, "optim", optimizer)  # ZeroRedundancyOptimizer's local AdamW
    return sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.ndim > 0)
