"""The video swap's progress manifest and the npz parameter loader.

Port of the inference half of ``vface_tpu/runtime/checkpoint.py``:

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
import time
from typing import Any, Dict, List, Optional

import numpy as np

from vface_torch.utils.convert import AUX_PARTS, PARTS, from_flax_aux, from_flax_params


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
    """A JAX ``save_params_npz`` file -> ``{part: state_dict}`` for the parts it
    holds: ``unet``, ``vae``, ``cond`` (a model bundle) and ``bisenet``,
    ``raft``, ``landmark``, ``detector`` (the aux nets). Raises on any other part."""
    tree = read_flat_npz(path)
    unknown = sorted(set(tree) - set(PARTS) - set(AUX_PARTS))
    if unknown:
        raise ValueError(f"{path}: unknown parameter groups {unknown} (expected {PARTS + AUX_PARTS})")
    return {**from_flax_params(tree), **from_flax_aux(tree)}
