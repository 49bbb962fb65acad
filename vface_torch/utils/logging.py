"""Metrics logging as JSON lines (port of ``vface_tpu/utils/logging.py``).

One record per call in ``<logdir>/<name>.jsonl``: ``step``, ``ts`` (wall-clock
seconds) and each value under ``prefix/key``, converted to a float where it
converts (a 0-d tensor included); the same record layout as the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, logdir: str, name: str = "metrics", echo: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{name}.jsonl")
        self.echo = echo
        self._f = open(self.path, "a", buffering=1)

    def log(self, step: int, values: Dict[str, Any], prefix: Optional[str] = None) -> None:
        rec = {"step": int(step), "ts": time.time()}
        for k, v in values.items():
            key = f"{prefix}/{k}" if prefix else k
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        self._f.write(json.dumps(rec) + "\n")
        if self.echo:
            print(f"[metrics] { {k: v for k, v in rec.items() if k != 'ts'} }")

    def close(self) -> None:
        self._f.close()
