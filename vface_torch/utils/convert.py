"""Parameters for the port: conversion from the JAX package's trees, and a seeded init.

:func:`from_flax_params` walks the Flax ``{"unet": ..., "vae": ...}`` trees
(nested dicts of numpy arrays) mechanically: the port's module attributes
mirror the Flax path names, so a path maps to a state-dict key by dropping the
wrapper levels (``Conv_0``, ``Dense_0``, ``GroupNorm_0``, ``LayerNorm_0``),
naming the auto-named ``GroupNorm32_0`` of the VAE attention ``norm``, and
renaming the leaf:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* GroupNorm / LayerNorm / frozen-BN ``scale`` -> ``weight``; ``bias`` stays
  ``bias``, and so do the conditioner's other leaves (CLIP's
  ``class_embedding`` and ``position_embedding``, the ``learnable_vector``,
  PReLU ``alpha``, frozen-BN ``mean`` and ``var``).

:func:`init_params` makes a seeded random init on any device, with no JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_DROP = {"Conv_0", "Dense_0", "GroupNorm_0", "LayerNorm_0"}
_RENAME = {"GroupNorm32_0": "norm"}
_KEEP = {"bias", "mean", "var", "alpha", "class_embedding", "position_embedding", "learnable_vector"}
PARTS = ("unet", "vae", "cond")


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    if name in _KEEP:
        return name, arr
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
    """``{"unet": ..., "vae": ...[, "cond": ...]}`` Flax trees -> the same keys as state dicts."""
    return {part: flax_tree_to_state_dict(tree[part]) for part in PARTS if part in tree}


def init_params(cfg, generator: torch.Generator, bias_std: float = 0.02, conditioner: bool = False) -> dict:
    """Seeded random parameters for ``cfg`` (a :class:`~vface_torch.models.ldm.ModelConfig`),
    made on the generator's device: ``{"unet": ..., "vae": ...}`` state dicts, and
    ``"cond"`` with ``conditioner`` (drawn after the others, so the UNet and VAE
    are the same either way).

    Conv and Dense weights are normal with std 1/sqrt(fan_in) (LeCun), the
    convs the reference zero-initialises included: with exact zeros there the
    UNet's epsilon is identically 0 and no attention kernel can affect the
    output. Biases are normal with std ``bias_std``; norm scales are 1 and
    norm biases 0. As in the JAX init: CLIP's class and position embeddings
    are normal with std 0.02, the learnable uncond vector standard normal,
    frozen BatchNorms the identity and PReLU slopes 0.25.
    """
    from vface_torch.models.clip import CLIPVisionTower
    from vface_torch.models.conditioning import Conditioner
    from vface_torch.models.layers import Conv, Dense, GroupNorm32, LayerNormF32
    from vface_torch.models.unet import UNetModel
    from vface_torch.models.vae import AutoencoderKL

    dev = generator.device
    randn = lambda shape: torch.randn(shape, generator=generator, device=dev)
    with torch.device(dev):
        parts = {"unet": UNetModel(cfg.unet), "vae": AutoencoderKL(cfg.vae)}
        if conditioner:
            parts["cond"] = Conditioner(cfg.cond)
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
                elif isinstance(mod, CLIPVisionTower):
                    mod.class_embedding.copy_(randn(mod.class_embedding.shape) * 0.02)
                    mod.position_embedding.copy_(randn(mod.position_embedding.shape) * 0.02)
        if conditioner:
            lv = parts["cond"].learnable_vector
            lv.copy_(randn(lv.shape))
    return {name: part.state_dict() for name, part in parts.items()}
