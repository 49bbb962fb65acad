"""Stable-Diffusion torch checkpoint -> Flax-path parameter trees (UNet, VAE, CLIP), for the port.

Port of ``vface_tpu/utils/sd_convert.py`` (numpy only; the port keeps its own
copy). It converts the reference's training checkpoint (SD-v1-4 with the
9-channel ``conv_in`` surgery of REFace's ``scripts/modify_checkpoints.py``
plus the REFace-trained mapper / proj / ID heads) into the JAX package's
trees, bit for bit: nested numpy arrays under the Flax paths, which the port's
modules mirror. :func:`model_state_dicts`, :func:`clip_text_state_dict` and
:func:`safety_params` give the port's state dicts directly;
:func:`vface_torch.runtime.checkpoint.save_params_npz` writes a tree as the
npz that the CLIs' ``--params`` read. The torch names follow the LDM layout
(``model.diffusion_model.*``, ``first_stage_model.*``, ``cond_stage_model.*``).

The UNet map is generated by replaying the same construction loop as
:class:`vface_torch.models.unet.UNetModel`, so block indices stay in lockstep
with the torch ``input_blocks``/``output_blocks`` numbering by construction.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from vface_torch.models.unet import UNetConfig
from vface_torch.models.vae import VAEConfig
from vface_torch.utils.torch_convert import _t, conv_kernel, linear_kernel, set_path


# ---------------------------------------------------------------- primitives


def _conv(sd, tp, tree, fp):
    set_path(tree, f"{fp}/Conv_0/kernel", conv_kernel(sd[f"{tp}.weight"]))
    if f"{tp}.bias" in sd:
        set_path(tree, f"{fp}/Conv_0/bias", _t(sd[f"{tp}.bias"]))


def _dense_wrap(sd, tp, tree, fp):
    """our Dense module (wraps nn.Dense as Dense_0)."""
    set_path(tree, f"{fp}/Dense_0/kernel", linear_kernel(sd[f"{tp}.weight"]))
    if f"{tp}.bias" in sd:
        set_path(tree, f"{fp}/Dense_0/bias", _t(sd[f"{tp}.bias"]))


def _dense_raw(sd, tp, tree, fp, bias=True):
    """bare nn.Dense (to_q/k/v/out etc.)."""
    set_path(tree, f"{fp}/kernel", linear_kernel(sd[f"{tp}.weight"]))
    if bias and f"{tp}.bias" in sd:
        set_path(tree, f"{fp}/bias", _t(sd[f"{tp}.bias"]))


def _gn(sd, tp, tree, fp):
    set_path(tree, f"{fp}/GroupNorm_0/scale", _t(sd[f"{tp}.weight"]))
    set_path(tree, f"{fp}/GroupNorm_0/bias", _t(sd[f"{tp}.bias"]))


def _ln(sd, tp, tree, fp):
    set_path(tree, f"{fp}/LayerNorm_0/scale", _t(sd[f"{tp}.weight"]))
    set_path(tree, f"{fp}/LayerNorm_0/bias", _t(sd[f"{tp}.bias"]))


# ----------------------------------------------------------------- UNet


def _st_block(sd, tp, tree, fp):
    """SpatialTransformer: torch `{tp}` → flax `{fp}`."""
    _gn(sd, f"{tp}.norm", tree, f"{fp}/norm")
    _conv(sd, f"{tp}.proj_in", tree, f"{fp}/proj_in")
    _conv(sd, f"{tp}.proj_out", tree, f"{fp}/proj_out")
    btp = f"{tp}.transformer_blocks.0"
    bfp = f"{fp}/block_0"
    for attn in ("attn1", "attn2"):
        _dense_raw(sd, f"{btp}.{attn}.to_q", tree, f"{bfp}/{attn}/to_q", bias=False)
        _dense_raw(sd, f"{btp}.{attn}.to_k", tree, f"{bfp}/{attn}/to_k", bias=False)
        _dense_raw(sd, f"{btp}.{attn}.to_v", tree, f"{bfp}/{attn}/to_v", bias=False)
        _dense_raw(sd, f"{btp}.{attn}.to_out.0", tree, f"{bfp}/{attn}/to_out")
    _dense_raw(sd, f"{btp}.ff.net.0.proj", tree, f"{bfp}/ff/geglu/proj")
    _dense_raw(sd, f"{btp}.ff.net.2", tree, f"{bfp}/ff/proj_out")
    for i in (1, 2, 3):
        _ln(sd, f"{btp}.norm{i}", tree, f"{bfp}/norm{i}")


def _res_block(sd, tp, tree, fp):
    _gn(sd, f"{tp}.in_layers.0", tree, f"{fp}/in_norm")
    _conv(sd, f"{tp}.in_layers.2", tree, f"{fp}/in_conv")
    _dense_wrap(sd, f"{tp}.emb_layers.1", tree, f"{fp}/emb_proj")
    _gn(sd, f"{tp}.out_layers.0", tree, f"{fp}/out_norm")
    _conv(sd, f"{tp}.out_layers.3", tree, f"{fp}/out_conv")
    if f"{tp}.skip_connection.weight" in sd:
        _conv(sd, f"{tp}.skip_connection", tree, f"{fp}/skip")


def convert_sd_unet(sd: Mapping, cfg: UNetConfig = UNetConfig(), prefix: str = "model.diffusion_model") -> Dict:
    """LDM UNet state_dict → UNetModel param tree (replays the build loop)."""
    tree: Dict = {}
    p = prefix
    _dense_wrap(sd, f"{p}.time_embed.0", tree, "time_embed_0")
    _dense_wrap(sd, f"{p}.time_embed.2", tree, "time_embed_2")
    _conv(sd, f"{p}.input_blocks.0.0", tree, "conv_in")

    ti = 1  # torch input_blocks index
    ds = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            _res_block(sd, f"{p}.input_blocks.{ti}.0", tree, f"in_{level}_{i}_res")
            if ds in cfg.attention_resolutions:
                _st_block(sd, f"{p}.input_blocks.{ti}.1", tree, f"in_{level}_{i}_attn")
            ti += 1
        if level != len(cfg.channel_mult) - 1:
            _conv(sd, f"{p}.input_blocks.{ti}.0.op", tree, f"in_{level}_down/op")
            ti += 1
            ds *= 2

    _res_block(sd, f"{p}.middle_block.0", tree, "mid_res_0")
    _st_block(sd, f"{p}.middle_block.1", tree, "mid_attn")
    _res_block(sd, f"{p}.middle_block.2", tree, "mid_res_1")

    to = 0  # torch output_blocks index
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            _res_block(sd, f"{p}.output_blocks.{to}.0", tree, f"out_{level}_{i}_res")
            sub = 1
            if ds in cfg.attention_resolutions:
                _st_block(sd, f"{p}.output_blocks.{to}.1", tree, f"out_{level}_{i}_attn")
                sub = 2
            if level != 0 and i == cfg.num_res_blocks:
                _conv(sd, f"{p}.output_blocks.{to}.{sub}.conv", tree, f"out_{level}_up/conv")
                ds //= 2
            to += 1

    _gn(sd, f"{p}.out.0", tree, "out_norm")
    _conv(sd, f"{p}.out.2", tree, "out_conv")
    return tree


# ----------------------------------------------------------------- VAE


def convert_sd_vae(sd: Mapping, cfg: VAEConfig = VAEConfig(), prefix: str = "first_stage_model") -> Dict:
    tree: Dict = {}
    p = prefix

    def res(tp, fp):
        for tn, fn in [("norm1", "norm1"), ("norm2", "norm2")]:
            _gn(sd, f"{tp}.{tn}", tree, f"{fp}/{fn}")
        _conv(sd, f"{tp}.conv1", tree, f"{fp}/conv1")
        _conv(sd, f"{tp}.conv2", tree, f"{fp}/conv2")
        if f"{tp}.nin_shortcut.weight" in sd:
            _conv(sd, f"{tp}.nin_shortcut", tree, f"{fp}/nin_shortcut")

    def attn(tp, fp):
        _gn(sd, f"{tp}.norm", tree, f"{fp}/GroupNorm32_0")
        for n in ("q", "k", "v", "proj_out"):
            _conv(sd, f"{tp}.{n}", tree, f"{fp}/{n}")

    # encoder
    _conv(sd, f"{p}.encoder.conv_in", tree, "encoder/conv_in")
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            res(f"{p}.encoder.down.{i}.block.{j}", f"encoder/down_{i}_block_{j}")
        if i != len(cfg.ch_mult) - 1:
            _conv(sd, f"{p}.encoder.down.{i}.downsample.conv", tree, f"encoder/down_{i}_downsample/conv")
    res(f"{p}.encoder.mid.block_1", "encoder/mid_block_1")
    attn(f"{p}.encoder.mid.attn_1", "encoder/mid_attn_1")
    res(f"{p}.encoder.mid.block_2", "encoder/mid_block_2")
    _gn(sd, f"{p}.encoder.norm_out", tree, "encoder/norm_out")
    _conv(sd, f"{p}.encoder.conv_out", tree, "encoder/conv_out")
    # decoder
    _conv(sd, f"{p}.decoder.conv_in", tree, "decoder/conv_in")
    res(f"{p}.decoder.mid.block_1", "decoder/mid_block_1")
    attn(f"{p}.decoder.mid.attn_1", "decoder/mid_attn_1")
    res(f"{p}.decoder.mid.block_2", "decoder/mid_block_2")
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks + 1):
            res(f"{p}.decoder.up.{i}.block.{j}", f"decoder/up_{i}_block_{j}")
        if i != 0:
            _conv(sd, f"{p}.decoder.up.{i}.upsample.conv", tree, f"decoder/up_{i}_upsample/conv")
    _gn(sd, f"{p}.decoder.norm_out", tree, "decoder/norm_out")
    _conv(sd, f"{p}.decoder.conv_out", tree, "decoder/conv_out")
    # quant convs
    _conv(sd, f"{p}.quant_conv", tree, "quant_conv")
    _conv(sd, f"{p}.post_quant_conv", tree, "post_quant_conv")
    return tree


# ----------------------------------------------------------------- CLIP + heads


def convert_clip_vision_tower(sd: Mapping, vp: str, tree: Dict, out: str, layers: int = 24) -> None:
    """HF CLIPVisionModel inner tower (`{vp}.embeddings/...`) → CLIPVisionTower
    subtree at ``out``. Shared by the conditioner and the safety checker."""
    set_path(tree, f"{out}/patch_embed/kernel", conv_kernel(sd[f"{vp}.embeddings.patch_embedding.weight"]))
    set_path(tree, f"{out}/class_embedding", _t(sd[f"{vp}.embeddings.class_embedding"]))
    set_path(tree, f"{out}/position_embedding", _t(sd[f"{vp}.embeddings.position_embedding.weight"]))
    _ln(sd, f"{vp}.pre_layrnorm", tree, f"{out}/pre_ln")
    _ln(sd, f"{vp}.post_layernorm", tree, f"{out}/post_ln")
    for i in range(layers):
        lp = f"{vp}.encoder.layers.{i}"
        fp = f"{out}/layer_{i}"
        _ln(sd, f"{lp}.layer_norm1", tree, f"{fp}/ln1")
        _ln(sd, f"{lp}.layer_norm2", tree, f"{fp}/ln2")
        for tn, fn in [("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out")]:
            _dense_raw(sd, f"{lp}.self_attn.{tn}", tree, f"{fp}/attn/{fn}")
        _dense_raw(sd, f"{lp}.mlp.fc1", tree, f"{fp}/fc1")
        _dense_raw(sd, f"{lp}.mlp.fc2", tree, f"{fp}/fc2")


def convert_clip_text_tower(sd: Mapping, tp: str, tree: Dict, out: str, layers: int = 12) -> None:
    """HF ``CLIPTextModel`` inner tower (`{tp}.embeddings/...`) →
    ``models.clip.CLIPTextTower`` subtree at ``out`` (the reference's
    ``FrozenCLIPTextEmbedder`` transformer, modules.py:178-207)."""
    set_path(tree, f"{out}/token_embedding", _t(sd[f"{tp}.embeddings.token_embedding.weight"]))
    set_path(tree, f"{out}/position_embedding", _t(sd[f"{tp}.embeddings.position_embedding.weight"]))
    _ln(sd, f"{tp}.final_layer_norm", tree, f"{out}/final_ln")
    for i in range(layers):
        lp = f"{tp}.encoder.layers.{i}"
        fp = f"{out}/layer_{i}"
        _ln(sd, f"{lp}.layer_norm1", tree, f"{fp}/ln1")
        _ln(sd, f"{lp}.layer_norm2", tree, f"{fp}/ln2")
        for tn, fn in [("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out")]:
            _dense_raw(sd, f"{lp}.self_attn.{tn}", tree, f"{fp}/attn/{fn}")
        _dense_raw(sd, f"{lp}.mlp.fc1", tree, f"{fp}/fc1")
        _dense_raw(sd, f"{lp}.mlp.fc2", tree, f"{fp}/fc2")


def convert_clip_text_encoder(sd: Mapping, layers: int = 12, prefix: str = "") -> Dict:
    """Full ``CLIPTextEncoder`` tree: the text tower plus the bias-free
    ``text_projection`` (for ``forward_probabilities``, modules.py:266-281).
    ``sd`` is an HF ``CLIPModel`` (or ``CLIPTextModel``; projection optional)
    state_dict, key prefix ``prefix``."""
    tree: Dict = {}
    convert_clip_text_tower(sd, f"{prefix}text_model", tree, "text", layers=layers)
    if f"{prefix}text_projection.weight" in sd:
        _dense_raw(sd, f"{prefix}text_projection", tree, "text_projection", bias=False)
    return tree


def convert_safety_checker(sd: Mapping) -> Dict:
    """HF ``StableDiffusionSafetyChecker`` state_dict → `utils.watermark.SafetyChecker`
    params (the port's ``vface_torch.utils.watermark.SafetyChecker`` takes them
    through :func:`safety_params`): the CLIP vision tower, the bias-free visual projection, and the
    concept/special-care embedding banks with their threshold buffers.

    The reference loads this checker via diffusers in `scripts/inference.py:88-101`
    (CompVis/stable-diffusion-safety-checker: CLIP ViT-L/14 tower, 17 concept +
    3 special-care embeddings at projection_dim 768).
    """
    n_layers = 0
    while f"vision_model.vision_model.encoder.layers.{n_layers}.layer_norm1.weight" in sd:
        n_layers += 1
    tree: Dict = {}
    convert_clip_vision_tower(sd, "vision_model.vision_model", tree, "clip", layers=n_layers)
    return {
        "clip": tree["clip"],
        "visual_projection": linear_kernel(sd["visual_projection.weight"]),
        "concept_embeds": _t(sd["concept_embeds"]),
        "concept_thresholds": _t(sd["concept_embeds_weights"]),
        "special_care_embeds": _t(sd["special_care_embeds"]),
        "special_care_thresholds": _t(sd["special_care_embeds_weights"]),
    }


def convert_clip_conditioner(sd: Mapping, layers: int = 24, prefix: str = "cond_stage_model") -> Dict:
    """FrozenCLIPEmbedder (HF CLIPModel vision tower + mapper2/final_ln2) →
    CLIPConditioner tree (modules.py:211-261)."""
    tree: Dict = {}
    convert_clip_vision_tower(sd, f"{prefix}.model.vision_model", tree, "vision", layers=layers)
    _dense_raw(sd, f"{prefix}.model.visual_projection", tree, "visual_projection", bias=False)
    # mapper2: xf.py ResidualAttentionBlocks with fused qkv
    i = 0
    while f"{prefix}.mapper2.resblocks.{i}.ln_1.weight" in sd:
        mp = f"{prefix}.mapper2.resblocks.{i}"
        fp = f"mapper2_{i}"
        _ln(sd, f"{mp}.ln_1", tree, f"{fp}/ln1")
        _ln(sd, f"{mp}.ln_2", tree, f"{fp}/ln2")
        # xf.py QKVMultiheadAttention uses one fused c_qkv Linear (width*3)
        if f"{mp}.attn.c_qkv.weight" in sd:
            wqkv = _t(sd[f"{mp}.attn.c_qkv.weight"])
            bqkv = _t(sd[f"{mp}.attn.c_qkv.bias"])
            d = wqkv.shape[0] // 3
            for j, n in enumerate(("q", "k", "v")):
                set_path(tree, f"{fp}/attn/{n}/kernel", wqkv[j * d : (j + 1) * d].T)
                set_path(tree, f"{fp}/attn/{n}/bias", bqkv[j * d : (j + 1) * d])
            _dense_raw(sd, f"{mp}.attn.c_proj", tree, f"{fp}/attn/out")
        _dense_raw(sd, f"{mp}.mlp.c_fc", tree, f"{fp}/fc1")
        _dense_raw(sd, f"{mp}.mlp.c_proj", tree, f"{fp}/fc2")
        i += 1
    _ln(sd, f"{prefix}.final_ln2", tree, "final_ln2")
    return tree


def convert_reface_heads(sd: Mapping) -> Dict:
    """The REFace-trained conditioning heads living on LatentDiffusion itself
    (ddpm.py:690-737): proj_out_source/target, ID_proj_out, landmark_proj_out,
    learnable_vector → Conditioner-level params."""
    tree: Dict = {}
    for tn, fn in [
        ("proj_out_source", "proj_out_source"),
        ("proj_out_target", "proj_out_target"),
        ("proj_out", "proj_out_source"),  # single-proj variants
        ("ID_proj_out", "id_proj_out"),
        ("landmark_proj_out", "landmark_proj_out"),
    ]:
        if f"{tn}.weight" in sd:
            _dense_raw(sd, tn, tree, fn)
    if "learnable_vector" in sd:
        set_path(tree, "learnable_vector", _t(sd["learnable_vector"]))
    return tree


def expand_conv_in_4_to_9(kernel_4ch: np.ndarray) -> np.ndarray:
    """The modify_checkpoints.py surgery (scripts/modify_checkpoints.py:1-8):
    zero-init the 5 extra input channels of conv_in. HWIO layout."""
    kh, kw, cin, cout = kernel_4ch.shape
    assert cin == 4
    out = np.zeros((kh, kw, 9, cout), kernel_4ch.dtype)
    out[:, :, :4] = kernel_4ch
    return out


# ------------------------------------------------------- the port's state dicts


def model_state_dicts(sd: Mapping, cfg, unet_prefix: str = "model.diffusion_model",
                      vae_prefix: str = "first_stage_model") -> Dict:
    """An LDM checkpoint's UNet and VAE -> ``{"unet": ..., "vae": ...}`` state
    dicts of the port's :class:`~vface_torch.models.ldm.VFaceModel` built from
    ``cfg`` (a ``ModelConfig``), through :func:`vface_torch.utils.convert.from_flax_params`."""
    from vface_torch.utils.convert import from_flax_params

    return from_flax_params({"unet": convert_sd_unet(sd, cfg.unet, prefix=unet_prefix),
                             "vae": convert_sd_vae(sd, cfg.vae, prefix=vae_prefix)})


def clip_text_state_dict(sd: Mapping, layers: int = 12, prefix: str = "") -> Dict:
    """An HF ``CLIPModel`` / ``CLIPTextModel`` state dict -> the state dict of
    :class:`vface_torch.models.clip.CLIPTextEncoder`."""
    from vface_torch.utils.convert import flax_tree_to_state_dict

    return flax_tree_to_state_dict(convert_clip_text_encoder(sd, layers=layers, prefix=prefix))


def safety_params(sd: Mapping) -> Dict:
    """An HF ``StableDiffusionSafetyChecker`` state dict -> what
    :class:`vface_torch.utils.watermark.SafetyChecker` takes
    (:func:`vface_torch.utils.convert.from_flax_safety`)."""
    from vface_torch.utils.convert import from_flax_safety

    return from_flax_safety(convert_safety_checker(sd))
