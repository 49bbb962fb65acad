"""The training driver: the step loop, checkpoints, image logs and validation, PyTorch.

Port of ``vface_tpu/pipelines/train_driver.py`` on one device:

* the step loop around :func:`vface_torch.pipelines.train.make_train_step`,
  one ``torch.Generator`` seeded with ``DriverConfig.seed`` on the model's
  device for every draw;
* ``scale_lr``: lr = base x devices x batch, with one device;
* every ``log_every`` steps the loss terms and ``sec_per_it`` into
  ``<logdir>/metrics.jsonl`` under ``train/``;
* every ``image_log_every`` steps ``encode -> decode`` of the batch's first
  four GT images, stacked vertically, to ``images/rec_%08d.png``;
* every ``ckpt_every`` steps ``checkpoints/last`` (params and optimizer state)
  and ``checkpoints/step_%08d`` (params; top-k on ``loss_simple``);
* on any exit, ``last`` again (torch state is never donated, so it always
  saves), unless the loop's own save wrote it at this step already, and the
  :class:`~vface_torch.utils.profiling.StageTimer` report.

:func:`validate` is the validation pass, with ``val/..._ema`` keys when given
EMA weights. The data-parallel mesh and the ZeRO-1 optimizer shard are
multi-GPU work (ROADMAP A13).
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
          device="cuda") -> VFaceModel:
    """Run the training loop over ``batches`` (numpy dicts, the keys of
    :func:`~vface_torch.pipelines.train.p_losses_face`); returns the trained
    model. The model is built with its conditioner on ``device`` and loaded
    with ``init_params`` (``{part: state_dict}``) or the seeded init from
    ``driver_cfg.seed``."""
    model = VFaceModel(model_cfg, device=device, conditioner=True)
    gen = torch.Generator(device=model.device).manual_seed(driver_cfg.seed)
    model.load_params(init_params if init_params is not None else seeded_params(model_cfg, gen, conditioner=True))
    if driver_cfg.scale_lr:
        n = 1  # devices
        lr = train_cfg.learning_rate * n * driver_cfg.batch_size
        train_cfg = dataclasses.replace(train_cfg, learning_rate=lr)
        print(f"[train] scaled lr to {lr:.2e} ({n} device x bs {driver_cfg.batch_size})")
    optimizer, scheduler = make_optimizer(train_cfg, model)
    step_fn = make_train_step(model, optimizer, scheduler, train_cfg, perceptual_fn)
    gen = torch.Generator(device=model.device).manual_seed(driver_cfg.seed)

    img_dir = os.path.join(driver_cfg.logdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    ckpt = TrainCheckpointer(os.path.join(driver_cfg.logdir, "checkpoints"))
    timer = StageTimer()
    metrics = MetricsLogger(driver_cfg.logdir, echo=False)
    state = lambda: {"params": model.param_state(), "opt_state": optimizer.state_dict()}
    step = saved = 0
    try:
        t_epoch = time.perf_counter()
        for batch in batches:
            if step >= driver_cfg.max_steps:
                break
            batch_dev = _to_device(batch, model.device)
            with timer.stage("train_step", sync_on=model.device):
                logs = step_fn(batch_dev, gen)
            step += 1
            if step % driver_cfg.log_every == 0:
                vals = {k: float(v) for k, v in logs.items()}
                vals["sec_per_it"] = (time.perf_counter() - t_epoch) / driver_cfg.log_every
                metrics.log(step, vals, prefix="train")
                print(f"[train] step {step} {vals}", flush=True)
                t_epoch = time.perf_counter()
            if step % driver_cfg.image_log_every == 0:
                with timer.stage("image_log", sync_on=model.device), torch.no_grad():
                    rec = model.decode_first_stage(model.encode_first_stage(batch_dev["gt_image"][:4]))
                    _save_image_grid(os.path.join(img_dir, f"rec_{step:08d}.png"),
                                     ((rec.float() + 1) * 0.5).cpu().numpy())
            if step % driver_cfg.ckpt_every == 0:
                with timer.stage("save_last"):
                    ckpt.save_last(state(), step)
                    saved = step
                with timer.stage("save_monitored"):
                    ckpt.save_monitored({"params": model.param_state()}, step, float(logs.get("loss_simple", 0.0)))
    finally:
        # the reference's melk(): the last state on any exit path
        if saved != step or step == 0:
            with timer.stage("save_last"):
                ckpt.save_last(state(), step)
        metrics.close()
        print(f"[train] saved last at step {step}", flush=True)
        print(f"[train] stages {json.dumps(timer.summary())}", flush=True)
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
