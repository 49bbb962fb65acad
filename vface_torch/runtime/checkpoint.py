"""Training checkpoints, the video swap's progress manifest and the npz parameter loader.

Port of ``vface_tpu/runtime/checkpoint.py``:

* :class:`TrainCheckpointer`: ``last`` (save_last) and top-k ``step_%08d``
  entries on a monitored metric, JAX's names and pruning order; each entry
  is one ``torch.save`` file of ``{"state": {...}, "step": n}`` (the port's own
  format: the model's ``{part: state_dict}`` under ``"params"`` and the
  optimizer's ``state_dict`` under ``"opt_state"``), written atomically;

* :class:`VideoProgressManifest`: a per-video JSON file naming the windows
  whose frames are on disk, so that a preempted run resumes by skipping them.
  Same JSON layout as the JAX package's (``{"windows": {"<start>": {"frames",
  "outputs", "ts"}}, "created", "meta"}``), written atomically (tmp + rename);
  a ``meta`` fingerprint that differs from the file's discards its progress.
* :func:`load_params_npz`: a flat npz that the JAX package's
  ``save_params_npz`` wrote (``/``-joined Flax paths, e.g.
  ``unet/in_0_0_res/in_conv/Conv_0/kernel``) -> the port's state dicts,
  through :func:`vface_torch.utils.convert.from_flax_params` and
  :func:`~vface_torch.utils.convert.from_flax_aux`.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vface_torch.utils.convert import AUX_PARTS, PARTS, from_flax_aux, from_flax_params


class TrainCheckpointer:
    """``last`` plus the ``keep_top_k`` entries with the lowest ``monitor``
    metric, in ``directory`` (the reference's ModelCheckpoint save_last and
    top-k). ``seconds`` lists each save's wall time."""

    def __init__(self, directory: str, keep_top_k: int = 30, monitor: str = "loss_simple"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_top_k = keep_top_k
        self.monitor = monitor
        self.seconds: List[float] = []
        self._scores: List[tuple] = []

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, name: str, state: Dict[str, Any], step: int) -> None:
        t0 = time.perf_counter()
        tmp = self._path(name + ".tmp")
        torch.save({"state": state, "step": step}, tmp)
        os.replace(tmp, self._path(name))
        self.seconds.append(time.perf_counter() - t0)

    def save_last(self, state: Dict[str, Any], step: int) -> None:
        self._save("last", state, step)

    def save_monitored(self, state: Dict[str, Any], step: int, metric: float) -> None:
        """Save ``step_%08d``, then drop the entries past the ``keep_top_k``
        lowest metrics (the highest first; ties by name)."""
        name = f"step_{step:08d}"
        self._save(name, state, step)
        self._scores.append((metric, name))
        self._scores.sort()
        while len(self._scores) > self.keep_top_k:
            _, worst = self._scores.pop()
            path = self._path(worst)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            elif os.path.exists(path):
                os.remove(path)

    def restore_last(self) -> Optional[Dict[str, Any]]:
        """``{"state": ..., "step": n}`` of ``last`` on the CPU, or None if there is none."""
        path = self._path("last")
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)


class VideoProgressManifest:
    """Which frame windows of one video are done, and where their frames live.

    ``meta`` fingerprints the run's configuration (window, steps, scale, ...):
    a file written under another fingerprint is discarded (with a message), so
    windows made at two operating points are never stitched into one output.
    """

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None):
        self.path = path
        self.data: Dict[str, Any] = {"windows": {}, "created": time.time(), "meta": meta or {}}
        if os.path.exists(path):
            with open(path) as f:
                loaded = json.load(f)
            loaded.setdefault("windows", {})
            if meta is not None and loaded.get("meta", {}) != meta:
                print(f"[manifest] {path}: config changed ({loaded.get('meta', {})} -> {meta}); "
                      "discarding stale progress")
            else:
                self.data = loaded

    def is_done(self, window_start: int) -> bool:
        return str(window_start) in self.data.get("windows", {})

    def mark_done(self, window_start: int, n_frames: int, output_paths: List[str]) -> None:
        self.data["windows"][str(window_start)] = {"frames": n_frames, "outputs": output_paths, "ts": time.time()}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f)
        os.replace(tmp, self.path)

    def completed_frames(self) -> int:
        return sum(w["frames"] for w in self.data.get("windows", {}).values())


def read_flat_npz(path) -> dict:
    """A flat npz of a Flax tree (``/``-joined paths) -> nested dicts of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = np.asarray(data[key])
    return tree


def load_params_npz(path: str) -> dict:
    """A JAX ``save_params_npz`` file -> ``{part: state_dict}`` for the parts it holds: ``unet``, ``vae``, ``cond``,
    ``landmark_head`` (a model bundle) and ``bisenet``, ``raft``, ``landmark``,
    ``detector`` (the aux nets). Raises on any other part."""
    tree = read_flat_npz(path)
    unknown = sorted(set(tree) - set(PARTS) - set(AUX_PARTS))
    if unknown:
        raise ValueError(f"{path}: unknown parameter groups {unknown} (expected {PARTS + AUX_PARTS})")
    return {**from_flax_params(tree), **from_flax_aux(tree)}
