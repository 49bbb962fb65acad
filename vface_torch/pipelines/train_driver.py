"""The training driver: the step loop, checkpoints, image logs and validation, PyTorch.

Port of ``vface_tpu/pipelines/train_driver.py``:

* the step loop around :func:`vface_torch.pipelines.train.make_train_step`,
  one ``torch.Generator`` seeded with ``DriverConfig.seed`` on the model's
  device for every draw;
* data-parallel over the ranks of a :mod:`vface_torch.parallel.mesh` mesh
  (one process per rank, ``torchrun``; one rank without it): every rank
  reads the same batches, takes its rows of each and its rows of the
  global batch's draws, the gradients are averaged over the ranks and the
  AdamW moments sharded (ZeRO-1), so that a step over n ranks is the
  one-rank step on the global batch;
* ``scale_lr``: lr = base x ranks x batch;
* every ``log_every`` steps the loss terms and ``sec_per_it`` into
  ``<logdir>/metrics.jsonl`` under ``train/``;
* every ``image_log_every`` steps ``encode -> decode`` of the batch's first
  four GT images, stacked vertically, to ``images/rec_%08d.png``;
* every ``ckpt_every`` steps ``checkpoints/last`` (params and optimizer state)
  and ``checkpoints/step_%08d`` (params; top-k on ``loss_simple``);
* on any exit, ``last`` again (torch state is never donated, so it always
  saves), unless the loop's own save wrote it at this step already, and the
  :class:`~vface_torch.utils.profiling.StageTimer` report. Over more than
  one rank the save is a collective, so it runs only when the loop ended
  normally: a rank whose step raised lets the exception end the run, and
  the other ranks, whose collectives then fail, end too (``torchrun`` ends
  them where a backend waits instead).

Over more than one rank the logs are the ranks' mean, and rank 0 alone
writes them, the image grids and the checkpoints; ``last`` holds the
optimizer state gathered into the layout of one AdamW, which a one-GPU run
reads. :func:`validate` is the validation pass, with ``val/..._ema`` keys
when given EMA weights; it runs on the process that calls it (rank 0).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from vface_torch.models.ldm import ModelConfig, VFaceModel
from vface_torch.pipelines.train import TrainConfig, make_optimizer, make_train_step, p_losses_face
from vface_torch.runtime.checkpoint import TrainCheckpointer
from vface_torch.utils.convert import init_params as seeded_params
from vface_torch.utils.logging import MetricsLogger
from vface_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class DriverConfig:
    logdir: str = "logs/vface"
    max_steps: int = 100_000
    log_every: int = 50
    image_log_every: int = 500  # the reference ImageLogger's batch frequency
    ckpt_every: int = 2_000
    scale_lr: bool = False
    batch_size: int = 1  # the reference operating point
    seed: int = 42


def _save_image_grid(path: str, images01: np.ndarray) -> None:
    from PIL import Image

    n, h, w, _ = images01.shape
    grid = (np.clip(images01, 0, 1) * 255).astype(np.uint8).reshape(n * h, w, 3)
    Image.fromarray(grid).save(path)


def _to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}


def train(model_cfg: ModelConfig, train_cfg: TrainConfig, driver_cfg: DriverConfig, batches: Iterator[dict],
          init_params: Optional[dict] = None, perceptual_fn: Optional[Callable] = None,
          device="cuda", n_data: Optional[int] = None) -> VFaceModel:
    """Run the training loop over ``batches`` (numpy dicts of the global
    batch, the keys of :func:`~vface_torch.pipelines.train.p_losses_face`);
    returns the trained model. The model is built with its conditioner on
    ``device`` (``"cuda"``: ``cuda:LOCAL_RANK``) and loaded with
    ``init_params`` (``{part: state_dict}``) or the seeded init from
    ``driver_cfg.seed``. The mesh is :func:`vface_torch.parallel.mesh.make_mesh`
    (``n_data``: every rank of the process group, or one rank without one);
    the ranks divide each batch's rows between them."""
    from vface_torch.parallel.mesh import make_mesh, optimizer_state_one_device, pmean, shard_rows

    mesh = make_mesh(n_data=n_data, device=device)
    lead = mesh.rank == 0
    model = VFaceModel(model_cfg, device=mesh.device, conditioner=True)
    gen = torch.Generator(device=model.device).manual_seed(driver_cfg.seed)
    model.load_params(init_params if init_params is not None else seeded_params(model_cfg, gen, conditioner=True))
    if driver_cfg.scale_lr:
        n = mesh.size
        lr = train_cfg.learning_rate * n * driver_cfg.batch_size
        train_cfg = dataclasses.replace(train_cfg, learning_rate=lr)
        if lead:
            print(f"[train] scaled lr to {lr:.2e} ({n} rank(s) x bs {driver_cfg.batch_size})")
    optimizer, scheduler = make_optimizer(train_cfg, model, mesh=mesh)
    step_fn = make_train_step(model, optimizer, scheduler, train_cfg, perceptual_fn, mesh=mesh)
    gen = torch.Generator(device=model.device).manual_seed(driver_cfg.seed)

    img_dir = os.path.join(driver_cfg.logdir, "images")
    ckpt = metrics = None
    if lead:
        os.makedirs(img_dir, exist_ok=True)
        ckpt = TrainCheckpointer(os.path.join(driver_cfg.logdir, "checkpoints"))
        metrics = MetricsLogger(driver_cfg.logdir, echo=False)
    timer = StageTimer()
    # every rank gathers the optimizer state (a collective); rank 0 saves it
    state = lambda: {"params": model.param_state(), "opt_state": optimizer_state_one_device(optimizer, mesh)}
    save_last = lambda: ckpt.save_last(state(), step) if lead else state()
    step = saved = 0
    ended = False  # the loop ran to its end on this rank
    try:
        t_epoch = time.perf_counter()
        for batch in batches:
            if step >= driver_cfg.max_steps:
                break
            rows = shard_rows(mesh, len(batch["gt_image"]))
            batch_dev = _to_device({k: v[rows] for k, v in batch.items()}, model.device)
            with timer.stage("train_step", sync_on=model.device):
                logs = step_fn(batch_dev, gen)
            step += 1
            if step % driver_cfg.log_every == 0:
                vals = {k: float(v) for k, v in pmean(logs, mesh).items()}
                vals["sec_per_it"] = (time.perf_counter() - t_epoch) / driver_cfg.log_every
                if lead:
                    metrics.log(step, vals, prefix="train")
                    print(f"[train] step {step} {vals}", flush=True)
                t_epoch = time.perf_counter()
            if step % driver_cfg.image_log_every == 0 and lead:
                with timer.stage("image_log", sync_on=model.device), torch.no_grad():
                    gt = _to_device({"gt_image": batch["gt_image"][:4]}, model.device)["gt_image"]
                    rec = model.decode_first_stage(model.encode_first_stage(gt))
                    _save_image_grid(os.path.join(img_dir, f"rec_{step:08d}.png"),
                                     ((rec.float() + 1) * 0.5).cpu().numpy())
            if step % driver_cfg.ckpt_every == 0:
                with timer.stage("save_last"):
                    save_last()
                    saved = step
                monitored = float(pmean(logs, mesh).get("loss_simple", 0.0))
                if lead:
                    with timer.stage("save_monitored"):
                        ckpt.save_monitored({"params": model.param_state()}, step, monitored)
        ended = True
    finally:
        # the reference's melk(): the last state on any exit path, over more than one rank on a normal one
        if (ended or mesh.size == 1) and (saved != step or step == 0):
            with timer.stage("save_last"):
                save_last()
        if lead:
            metrics.close()
            if ended or mesh.size == 1:
                print(f"[train] saved last at step {step}", flush=True)
        print(f"[train] stages {json.dumps(timer.summary())}" + (f" rank {mesh.rank}" if mesh.size > 1 else ""),
              flush=True)
    return model


@torch.no_grad()
def validate(model: VFaceModel, train_cfg: TrainConfig, val_batches: Iterator[dict],
             generator: Optional[torch.Generator] = None, ema_params: Optional[dict] = None,
             max_batches: int = 50) -> Dict[str, float]:
    """The validation pass: the mean of every :func:`p_losses_face` log over up
    to ``max_batches`` batches as ``val/<key>``, and with ``ema_params`` (a
    ``{parameter name: tensor}`` dict, :mod:`vface_torch.utils.ema`) the same
    under ``val/<key>_ema``, each batch on the draws of its first pass. The EMA
    weights are loaded into ``model`` for their pass and the model's own
    restored after it (one model's memory, plus a host copy of the swapped
    parameters)."""
    gen = generator if generator is not None else torch.Generator(device=model.device).manual_seed(0)
    batches = list(itertools.islice(val_batches, max_batches))
    states = []
    sums: Dict[str, float] = {}

    def run(suffix: str) -> None:
        for i, batch in enumerate(batches):
            if suffix:
                gen.set_state(states[i])
            else:
                states.append(gen.get_state())
            for k, v in p_losses_face(model, _to_device(batch, model.device), gen, train_cfg)[1].items():
                sums[f"val/{k}{suffix}"] = sums.get(f"val/{k}{suffix}", 0.0) + float(v)

    run("")
    if ema_params is not None:
        params = dict(model.named_parameters())
        own = {k: params[k].detach().to("cpu", copy=True) for k in ema_params}
        _copy_into(params, ema_params)
        try:
            run("_ema")
        finally:
            _copy_into(params, own)
    return {k: v / max(len(batches), 1) for k, v in sums.items()}


def _copy_into(params: Dict[str, torch.nn.Parameter], values: Dict[str, torch.Tensor]) -> None:
    for k, v in values.items():
        params[k].data.copy_(v)
