"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the CPU.

    Raises when a CUDA device is asked for and none is present; the port never
    falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vface_torch: CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_from_env() -> torch.device:
    """The device a command-line entry point runs on: the CPU when the
    environment sets ``VFACE_PLATFORM=cpu`` (the JAX package's CLIs read the
    same variable to pick their platform), else CUDA, which raises without a
    card. Any other value of the variable raises."""
    plat = os.environ.get("VFACE_PLATFORM", "").strip().lower()
    if plat not in ("", "cpu", "cuda", "gpu"):
        raise ValueError(f"VFACE_PLATFORM={plat!r}: the port runs on 'cpu' or 'cuda'")
    return resolve_device("cpu" if plat == "cpu" else "cuda")
