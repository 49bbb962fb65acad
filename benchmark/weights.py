"""Weights made from the seed, by the rules of the reference's modules.

Every random weight of a set of modules comes from one draw on the device
(one ``torch.randn`` over their total size, from a ``torch.Generator``
seeded with the run's seed), cut into views by state-dict key and scaled:
conv and dense weights LeCun normal (std 1 / sqrt(fan_in)), their biases
std 0.02, CLIP's class and position embeddings std 0.02, the conditioner's
learnable uncond vector std 1; norms, frozen batch-norm statistics and PReLU
slopes at their identity values. A key that no rule covers raises. The
program gets the same state dicts: its modules carry the same keys.

The landmark net is the one trained part: its weights are the repository's
shipped file, read as data and mapped from the Flax tree's paths.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.arcface import PReLU, _FrozenBNParams
from benchmark.reference.clip import CLIPVisionTower
from benchmark.reference.conditioning import Conditioner
from benchmark.reference.layers import Conv, Dense, GroupNorm32, LayerNormF32
from benchmark.reference.raft import InstanceNorm

LANDMARK_NPZ = Path(__file__).resolve().parents[1] / "vface_tpu" / "weights" / "landmark_net.npz"
BIAS_STD = 0.02
EMBED_STD = 0.02


def _rule(mod, name: str, shape):
    """(kind, value): "randn" with a std, or "fill" with a constant."""
    if isinstance(mod, (Conv, Dense)):
        if name == "weight":
            return "randn", 1.0 / math.sqrt(math.prod(shape[1:]))
        if name == "bias":
            return "randn", BIAS_STD
    if isinstance(mod, (GroupNorm32, LayerNormF32, InstanceNorm)):
        return "fill", 1.0 if name == "weight" else 0.0
    if isinstance(mod, _FrozenBNParams):
        return "fill", 1.0 if name in ("weight", "var") else 0.0
    if isinstance(mod, PReLU) and name == "alpha":
        return "fill", 0.25
    if isinstance(mod, CLIPVisionTower) and name in ("class_embedding", "position_embedding"):
        return "randn", EMBED_STD
    if isinstance(mod, Conditioner) and name == "learnable_vector":
        return "randn", 1.0
    raise KeyError(f"no weight rule for {type(mod).__name__}.{name}")


def seeded_state_dicts(parts: dict, seed: int, device) -> dict:
    """``{name: module}`` (on any device, meta included) -> ``{name: state_dict}``
    on ``device``, the same for the same seed and the same modules."""
    plan = []
    for pname, part in parts.items():
        for mname, mod in part.named_modules():
            for leaf, p in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
                plan.append((pname, f"{mname}.{leaf}" if mname else leaf, tuple(p.shape), *_rule(mod, leaf, p.shape)))
    total = sum(math.prod(shape) for *_, shape, kind, _ in plan if kind == "randn")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    draw = torch.randn(total, generator=gen, device=device)
    out = {pname: {} for pname in parts}
    at = 0
    with torch.no_grad():
        for pname, key, shape, kind, value in plan:
            n = math.prod(shape)
            if kind == "randn":
                out[pname][key] = draw[at:at + n].view(shape).mul_(value)
                at += n
            else:
                out[pname][key] = torch.full(shape, value, device=device)
    return out


def _flax_leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        return "weight", arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise ValueError(f"unknown Flax leaf {name!r}")


def landmark_state_dict(device, path: Path = LANDMARK_NPZ) -> dict:
    """The shipped landmark net: flat "conv_0/kernel" keys -> the module's state dict."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            *mods, leaf = key.split("/")
            name, arr = _flax_leaf(leaf, np.asarray(data[key], dtype=np.float32))
            out[".".join(m for m in mods if m not in ("Conv_0", "GroupNorm_0")) + "." + name] = (
                torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return out
