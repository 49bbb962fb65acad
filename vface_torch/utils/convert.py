"""Parameters for the port: conversion from the JAX package's trees, and a seeded init.

:func:`from_flax_params` walks the Flax ``{"unet": ..., "vae": ...}`` trees
(nested dicts of numpy arrays) mechanically: the port's module attributes
mirror the Flax path names, so a path maps to a state-dict key by dropping the
wrapper levels (``Conv_0``, ``Dense_0``, ``GroupNorm_0``, ``LayerNorm_0``),
naming the auto-named ``GroupNorm32_0`` of the VAE attention ``norm``, and
renaming the leaf:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW (a 3-D conv's DHWIO -> OIDHW);
* GroupNorm / LayerNorm / frozen-BN ``scale`` -> ``weight``; ``bias`` stays
  ``bias``, and so do the conditioner's other leaves (CLIP's
  ``class_embedding``, ``position_embedding`` and the text tower's
  ``token_embedding``, the ``learnable_vector``, PReLU ``alpha``, frozen-BN
  ``mean`` and ``var``) and the VQ codebook's ``embedding``.

The training nets convert with the same walk: the bundle's optional
``landmark_head`` (:class:`~vface_torch.preprocess.landmarks.UNetLandmarkHead`)
is a part of :func:`from_flax_params`; an ``LPIPS`` tree
(:class:`~vface_torch.eval.lpips.LPIPS`) and a ``PatchDiscriminator`` tree
(:class:`~vface_torch.pipelines.vae_train.PatchDiscriminator`) convert with
:func:`flax_tree_to_state_dict`.

:func:`init_params` makes a seeded random init on any device, with no JAX.

Other trees convert with the same walk: an ``EncoderUNetModel`` tree
(:class:`~vface_torch.models.unet.EncoderUNetModel`) with
:func:`flax_tree_to_state_dict`, the conditioner's token-mode parameters
(``concat_feat_proj``, ``other_learnable_vector``) inside "cond", and the
safety checker's tree with :func:`from_flax_safety`.

The evaluation nets (``{"inception", "arcface", "hopenet", "facerecon"}``:
``InceptionV3Pool3``, ``IRSE50``, ``Hopenet``, ``FaceReconNet`` of
:mod:`vface_torch.eval`) follow it too: :func:`from_flax_eval`.

The video swap's aux nets (``{"bisenet", "raft", "landmark", "detector"}``)
follow the same walk (the detector's Flax ``nn.GroupNorm`` ``scale`` is a
``weight`` too): :func:`from_flax_aux` converts their Flax trees, and
:func:`init_aux_params` makes them seeded (the landmark net and the face
detector from the JAX package's shipped weights, read as data, where the
files are present).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_DROP = {"Conv_0", "Dense_0", "GroupNorm_0", "LayerNorm_0"}
_RENAME = {"GroupNorm32_0": "norm"}
_KEEP = {"bias", "mean", "var", "alpha", "class_embedding", "position_embedding", "learnable_vector",
         "other_learnable_vector", "token_embedding", "embedding"}
PARTS = ("unet", "vae", "cond", "landmark_head")
AUX_PARTS = ("bisenet", "raft", "landmark", "detector")


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:  # Conv3d: DHWIO -> OIDHW
            return "weight", arr.transpose(4, 3, 0, 1, 2)
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
    """``{"unet": ..., "vae": ...[, "cond": ...][, "landmark_head": ...]}`` Flax trees -> the
    same keys as state dicts."""
    return {part: flax_tree_to_state_dict(tree[part]) for part in PARTS if part in tree}


def set_path(tree: dict, path: str, value) -> None:
    """Put ``value`` at the "/"-separated ``path`` of nested dicts (a flat npz key
    such as ``clip/layer_0/attn/q/kernel``), making the levels it needs."""
    *parts, leaf = path.split("/")
    node = tree
    for p in parts:
        node = node.setdefault(p, {})
    node[leaf] = value


SAFETY_ARRAYS = ("visual_projection", "concept_embeds", "concept_thresholds", "special_care_embeds",
                 "special_care_thresholds")


def from_flax_safety(tree) -> dict:
    """The safety checker's tree (``{"clip": a CLIPVisionTower tree, "visual_projection",
    "concept_embeds", "concept_thresholds", "special_care_embeds",
    "special_care_thresholds"}``, or its flat ``clip/<path>`` keys as an npz
    holds them) -> ``{"clip": the tower's state dict, <the arrays> as float32
    numpy}``, what :class:`vface_torch.utils.watermark.SafetyChecker` takes."""
    nested = {}
    for key, value in tree.items():
        set_path(nested, key, value)
    out = {"clip": flax_tree_to_state_dict(nested["clip"])}
    out.update({k: np.asarray(nested[k], np.float32) for k in SAFETY_ARRAYS})
    return out


def from_flax_aux(tree) -> dict:
    """``{"bisenet": ..., "raft": ..., "landmark": ..., "detector": ...}`` Flax trees (any subset)
    -> the same keys as state dicts of the port's aux modules."""
    return {part: flax_tree_to_state_dict(tree[part]) for part in AUX_PARTS if part in tree}


EVAL_PARTS = ("inception", "arcface", "hopenet", "facerecon")


def from_flax_eval(tree) -> dict:
    """``{"inception": ..., "arcface": ..., "hopenet": ..., "facerecon": ...}`` Flax trees
    (any subset; the JAX package's ``evaluate_all`` ``eval_params``) -> the same
    keys as state dicts of the port's eval nets."""
    return {part: flax_tree_to_state_dict(tree[part]) for part in EVAL_PARTS if part in tree}


def init_aux_params(generator: torch.Generator) -> dict:
    """Seeded aux-net parameters on the generator's device: ``{"bisenet",
    "raft", "landmark", "detector"}`` state dicts, conv weights LeCun-normal,
    conv biases normal with std 0.02, norms and frozen-BN statistics the
    identity. The landmark net and the detector take the JAX package's
    trained weights where the shipped files are present."""
    from vface_torch.models.bisenet import BiSeNet
    from vface_torch.models.layers import Conv
    from vface_torch.models.raft import RAFT
    from vface_torch.preprocess.detector import FaceDetector, load_default_detector_params
    from vface_torch.preprocess.landmarks import LandmarkNet, load_default_landmark_params

    dev = generator.device
    randn = lambda shape: torch.randn(shape, generator=generator, device=dev)
    with torch.device(dev):
        parts = {"bisenet": BiSeNet(), "raft": RAFT(), "landmark": LandmarkNet(), "detector": FaceDetector()}
    with torch.no_grad():
        for part in parts.values():
            for mod in part.modules():
                if isinstance(mod, Conv):
                    mod.weight.copy_(randn(mod.weight.shape) / math.sqrt(math.prod(mod.weight.shape[1:])))
                    if mod.bias is not None:
                        mod.bias.copy_(randn(mod.bias.shape) * 0.02)
    out = {name: part.state_dict() for name, part in parts.items()}
    for name, load in (("landmark", load_default_landmark_params), ("detector", load_default_detector_params)):
        shipped = load()
        if shipped is not None:
            out[name] = {k: v.to(dev) for k, v in flax_tree_to_state_dict(shipped).items()}
    return out


def init_params(cfg, generator: torch.Generator, bias_std: float = 0.02, conditioner: bool = False,
                landmark_head: bool = False) -> dict:
    """Seeded random parameters for ``cfg`` (a :class:`~vface_torch.models.ldm.ModelConfig`),
    made on the generator's device: ``{"unet": ..., "vae": ...}`` state dicts,
    ``"cond"`` with ``conditioner`` and ``"landmark_head"`` with
    ``landmark_head`` (drawn after the others, in that order, so the earlier
    parts are the same either way).

    Conv and Dense weights are normal with std 1/sqrt(fan_in) (LeCun), the
    convs the reference zero-initialises included: with exact zeros there the
    UNet's epsilon is identically 0 and no attention kernel can affect the
    output. Biases are normal with std ``bias_std``; norm scales are 1 and
    norm biases 0. As in the JAX init: CLIP's class and position embeddings
    are normal with std 0.02, the learnable uncond vectors standard normal,
    frozen BatchNorms the identity and PReLU slopes 0.25.
    """
    from vface_torch.models.clip import CLIPVisionTower
    from vface_torch.models.conditioning import Conditioner
    from vface_torch.models.layers import Conv, Dense, GroupNorm32, LayerNormF32
    from vface_torch.models.unet import UNetModel
    from vface_torch.models.vae import AutoencoderKL
    from vface_torch.preprocess.landmarks import UNetLandmarkHead

    dev = generator.device
    randn = lambda shape: torch.randn(shape, generator=generator, device=dev)
    with torch.device(dev):
        parts = {"unet": UNetModel(cfg.unet), "vae": AutoencoderKL(cfg.vae)}
        if conditioner:
            parts["cond"] = Conditioner(cfg.cond)
        if landmark_head:
            parts["landmark_head"] = UNetLandmarkHead(2 * cfg.unet.model_channels, cfg.latent_size)
    order = [parts[k] for k in ("unet", "vae", "cond") if k in parts]
    with torch.no_grad():
        for i, part in enumerate(order + [parts.get("landmark_head")]):
            if i == len(order) and conditioner:  # the uncond vectors before the head
                for name in ("learnable_vector", "other_learnable_vector"):
                    lv = getattr(parts["cond"], name, None)
                    if lv is not None:
                        lv.copy_(randn(lv.shape))
            if part is None:
                continue
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
    return {name: part.state_dict() for name, part in parts.items()}
