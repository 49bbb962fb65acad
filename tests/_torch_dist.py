"""Multi-rank helpers for the port's CPU tests: n ranks over gloo, one process each.

Torch only (no JAX): :func:`run_ranks` spawns the ranks with the ``spawn``
start method, so every child imports this module and the port, never a test
file (which would import JAX). Each rank joins a gloo group through a file
in the test's temporary directory (no TCP port: pytest-xdist workers run side
by side), runs one of the functions below on the inputs the parent saved,
saves its result, and ends the group. Each child runs torch on one thread.
"""

from __future__ import annotations

import os
import traceback

import torch
import torch.multiprocessing as mp


def _child(rank: int, world: int, tmp: str, fn_name: str) -> None:
    torch.set_num_threads(1)
    from vface_torch.parallel.mesh import destroy, make_mesh

    try:
        mesh = make_mesh(device="cpu", backend="gloo", init_method=f"file://{tmp}/pg", rank=rank,
                         world_size=world)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = globals()[fn_name](mesh, inputs)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy()


def spawn_ranks(fn_name: str, world: int, inputs, tmp_path, timeout: float = 300.0):
    """Run ``fn_name(mesh, inputs)`` on ``world`` gloo ranks; returns the
    exit codes (a rank still running after ``timeout`` seconds in all is
    killed: -9) and each failed rank's traceback, by rank."""
    import time

    tmp = str(tmp_path)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, tmp, fn_name)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: open(os.path.join(tmp, f"err{r}.txt")).read() for r in range(world)
            if os.path.exists(os.path.join(tmp, f"err{r}.txt"))}
    return [p.exitcode for p in procs], errs


def run_ranks(fn_name: str, world: int, inputs, tmp_path, timeout: float = 300.0) -> list:
    """Run ``fn_name(mesh, inputs)`` on ``world`` gloo ranks; returns each rank's result."""
    codes, errs = spawn_ranks(fn_name, world, inputs, tmp_path, timeout)
    if errs or any(c != 0 for c in codes):
        raise RuntimeError(f"rank(s) failed (exit codes {codes}):\n" + "\n".join(errs.values()))
    return [torch.load(os.path.join(str(tmp_path), f"out{r}.pt"), weights_only=False) for r in range(world)]


# ------------------------------------------------------------ mesh functions
def halo_pmean_align(mesh, x):
    """Each rank's halo, pmean of its rows' sum, and the halo FGATS blend."""
    from vface_torch.parallel.mesh import align_by_flow_sharded, frame_halo_exchange, pmean, shard_rows

    from vface_torch.ops.attention import FusionConfig, fuse_qkv

    rows = shard_rows(mesh, x["frames"].shape[0])
    local = x["frames"][rows]
    fused = {}
    for chunks in (2, 3):
        q, k, v = (x["qkv"][n][:chunks, rows] for n in "qkv")
        cfg = FusionConfig("flow_fix", flow_tokens=q.shape[2], use_circulant=False, two_chunk_replace=chunks == 3,
                           flow_axis="data")
        qo, ko, vo, _ = fuse_qkv(*(a.reshape((-1,) + a.shape[2:]) for a in (q, k, v)), cfg, chunks=chunks,
                                 flow=x["flow_pad"][rows], pair_mask=x["pm_pad"][rows])
        fused[f"fuse_{chunks}"] = torch.stack([qo, ko, vo])
    return dict(**fused, halo=frame_halo_exchange(local, "data"),
                pmean=pmean(local.sum(), "data"),
                align=align_by_flow_sharded(x["x"][rows], x["flow_pad"][rows], alpha=0.8),
                align_masked=align_by_flow_sharded(x["x"][rows], x["flow_pad"][rows], alpha=0.8,
                                                   pair_mask=x["pm_pad"][rows]))


def _tiny_model(state, image_size=32, conditioner=False):
    from vface_torch.models.ldm import ModelConfig, VFaceModel

    model = VFaceModel(ModelConfig.tiny(image_size=image_size), device="cpu", conditioner=conditioner)
    model.load_params(state)
    return model


def frame_sharded_sample(mesh, x):
    """``vface_sample_frame_sharded`` with and without a pair mask."""
    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops.attention import FusionConfig
    from vface_torch.parallel.frame_sharded import vface_sample_frame_sharded
    from vface_torch.parallel.mesh import shard_rows

    model = _tiny_model(x["state"])
    spec = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=x["tokens"]), chunks=3)
    a = x["args"]
    rows = shard_rows(mesh, a["x_T"].shape[0])  # this rank's frames of the window
    own = {k: a[k][rows] for k in ("x_T", "cond", "uncond", "inpaint", "mask")}
    out = {}
    with torch.inference_mode():
        for key, pm in (("plain", None), ("masked", x["pair_mask"])):
            out[key] = vface_sample_frame_sharded(model, own["x_T"], own["cond"], own["uncond"], own["cond"],
                                                  own["inpaint"], own["mask"], spec, flow=a["flow"], mesh=mesh,
                                                  num_steps=2, flow_pair_mask=pm)
    return out


def _pipe(x, **fields):
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

    model = _tiny_model(x["state"], conditioner=True)
    return VideoSwapPipeline(model, SwapOptions(**{**x["opts"], **fields}), device="cpu", aux_params=x["aux"])


class _Manifest:
    """Records ``mark_done`` calls."""

    def __init__(self):
        self.marks = []

    def mark_done(self, s0, count, paths):
        self.marks.append((s0, count, list(paths)))


def sharded_video(mesh, x):
    """``swap_video_frames_sharded`` (with a manifest and a sink on rank 0),
    ``swap_video_frames_frame_sharded`` on one clip, and ``swap_windows_batched``."""
    pipe = _pipe(x)
    manifest = _Manifest()
    sunk = []
    sink = lambda s0, frames: sunk.append((s0, frames.shape[0])) or [f"{s0 + j}.png" for j in range(frames.shape[0])]
    out = dict(sharded=pipe.swap_video_frames_sharded(x["frames"], x["source"], mesh, manifest=manifest,
                                                      window_sink=sink, frame_keep=x["keep"],
                                                      source_keep=x["keep"][0]),
               marks=manifest.marks, sunk=sunk)
    out["frame_sharded"] = pipe.swap_video_frames_frame_sharded(x["frames"], x["source"], mesh)
    out["windows"] = pipe.swap_windows_batched(*x["windows"], mesh=mesh)
    return out


def train_steps(mesh, x):
    """Each variant of ``x["variants"]`` from the same params on this rank's rows."""
    return {name: _train_variant(mesh, x, v) for name, v in x["variants"].items()}


def _train_variant(mesh, x, v):
    """Data-parallel steps (fused or split, generator draws) or, with
    ``fixed``, the averaged gradients of the loss on the global batch's
    ``fixed`` draws and then two ZeRO-1 steps fed the given gradients. Returns
    the params, the optimizer-state bytes this rank holds and the state
    gathered into the one-device layout."""
    from vface_torch.parallel.mesh import all_reduce_grads, local_state_bytes, optimizer_state_one_device
    from vface_torch.pipelines import train as TT

    model = _tiny_model(x["state"], conditioner=True)
    cfg = TT.TrainConfig(**x["cfg"])
    opt, sched = TT.make_optimizer(cfg, model, mesh=mesh)
    rows = slice(mesh.rank * x["b_local"], (mesh.rank + 1) * x["b_local"])
    batch = {k: val[rows] for k, val in x["batch"].items()}
    out = {}
    if "fixed" in v:
        loss, _ = TT.p_losses_face(model, batch, None, cfg, v["fixed"], mesh=mesh)
        loss.backward()
        all_reduce_grads(list(model.parameters()), mesh)
        out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        for scale in (1.0, 1.5):
            for k, p in model.named_parameters():
                p.grad = v["feed"][k] * scale if p.requires_grad else None
            opt.step()
            sched.step()
    else:
        make = TT.make_split_train_step if v["split"] else TT.make_train_step
        step = make(model, opt, sched, cfg, mesh=mesh)
        gen = torch.Generator().manual_seed(v["seed"])
        out["logs"] = [{k: float(val) for k, val in step(batch, gen).items()} for _ in range(v["steps"])]
    out.update(params={k: p.detach().clone() for k, p in model.named_parameters()}, state_bytes=local_state_bytes(opt),
               opt_state=optimizer_state_one_device(opt, mesh))
    return out


def train_driver(mesh, x):
    """``train(n_data=size)`` into the shared logdir; the params and the learning rate it took."""
    from vface_torch.models.ldm import ModelConfig
    from vface_torch.pipelines import train_driver as TD
    from vface_torch.pipelines.train import TrainConfig

    lrs = []
    real = TD.make_optimizer
    TD.make_optimizer = lambda cfg, *a, **kw: lrs.append(cfg.learning_rate) or real(cfg, *a, **kw)
    model = TD.train(ModelConfig.tiny(image_size=32), TrainConfig(**x["cfg"]), TD.DriverConfig(**x["driver"]),
                     iter(x["batches"]), init_params=x["init"], device="cpu", n_data=mesh.size)
    return dict(params={k: v.detach().clone() for k, v in model.named_parameters()}, lr=lrs)


def train_driver_rank_fails(mesh, x):
    """``train(n_data=size)`` whose last rank raises in its second step."""
    from vface_torch.pipelines import train_driver as TD

    real = TD.make_train_step

    def make(*a, **kw):
        step, calls = real(*a, **kw), []

        def failing(batch, gen):
            calls.append(1)
            if len(calls) == 2 and mesh.rank == mesh.size - 1:
                raise RuntimeError("injected failure on the last rank")
            return step(batch, gen)

        return failing

    TD.make_train_step = make
    return train_driver(mesh, x)


def video_cli_rank_fails(mesh, x):
    """The video CLI whose last rank raises in the frame-sharded epilogue of each window."""
    from vface_torch.pipelines.video_swap import VideoSwapPipeline

    if mesh.rank == mesh.size - 1:
        def fail(*a, **kw):
            raise RuntimeError("injected failure on the last rank")

        VideoSwapPipeline._fs_post = fail
    return video_cli(mesh, x)


def video_cli(mesh, x):
    """The video CLI in process on this rank, once per argv of ``x["argvs"]``; the exit codes."""
    from vface_torch.scripts import vface_video_swap

    os.environ["VFACE_PLATFORM"] = "cpu"
    return [vface_video_swap.main(argv) for argv in x["argvs"]]
