"""Parameters for the port: conversion from the JAX package's trees, and a seeded init.

:func:`from_flax_params` walks the Flax ``{"unet": ..., "vae": ...}`` trees
(nested dicts of numpy arrays) mechanically: the port's module attributes
mirror the Flax path names, so a path maps to a state-dict key by dropping the
wrapper levels (``Conv_0``, ``Dense_0``, ``GroupNorm_0``, ``LayerNorm_0``),
naming the auto-named ``GroupNorm32_0`` of the VAE attention ``norm``, and
renaming the leaf:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* GroupNorm / LayerNorm ``scale`` -> ``weight``; ``bias`` stays ``bias``.

:func:`init_params` makes a seeded random init on any device, with no JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_DROP = {"Conv_0", "Dense_0", "GroupNorm_0", "LayerNorm_0"}
_RENAME = {"GroupNorm32_0": "norm"}


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise ValueError(f"unknown Flax leaf {name!r}")


def flax_tree_to_state_dict(tree) -> dict:
    """One Flax param tree (nested mappings of arrays) -> a PyTorch state dict."""
    out = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for key, sub in node.items():
                walk(sub, path + [key])
            return
        *mods, leaf = path
        name, arr = _leaf(leaf, np.asarray(node, dtype=np.float32))
        parts = [_RENAME.get(p, p) for p in mods if p not in _DROP]
        out[".".join(parts + [name])] = torch.from_numpy(np.array(arr, dtype=np.float32))

    walk(tree, [])
    return out


def from_flax_params(tree) -> dict:
    """``{"unet": flax tree, "vae": flax tree}`` -> ``{"unet": state_dict, "vae": state_dict}``."""
    return {part: flax_tree_to_state_dict(tree[part]) for part in ("unet", "vae")}


def init_params(cfg, generator: torch.Generator, bias_std: float = 0.02) -> dict:
    """Seeded random parameters for ``cfg`` (a :class:`~vface_torch.models.ldm.ModelConfig`),
    made on the generator's device: ``{"unet": state_dict, "vae": state_dict}``.

    Conv and Dense weights are normal with std 1/sqrt(fan_in) (LeCun), the
    convs the reference zero-initialises included: with exact zeros there the
    UNet's epsilon is identically 0 and no attention kernel can affect the
    output. Biases are normal with std ``bias_std``; norm scales are 1 and
    norm biases 0.
    """
    from vface_torch.models.layers import Conv, Dense, GroupNorm32, LayerNormF32
    from vface_torch.models.unet import UNetModel
    from vface_torch.models.vae import AutoencoderKL

    dev = generator.device
    randn = lambda shape: torch.randn(shape, generator=generator, device=dev)
    with torch.device(dev):
        parts = {"unet": UNetModel(cfg.unet), "vae": AutoencoderKL(cfg.vae)}
    with torch.no_grad():
        for part in parts.values():
            for mod in part.modules():
                if isinstance(mod, (Conv, Dense)):
                    fan_in = math.prod(mod.weight.shape[1:])
                    mod.weight.copy_(randn(mod.weight.shape) / math.sqrt(fan_in))
                    if mod.bias is not None:
                        mod.bias.copy_(randn(mod.bias.shape) * bias_std)
                elif isinstance(mod, (GroupNorm32, LayerNormF32)):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
    return {name: part.state_dict() for name, part in parts.items()}
