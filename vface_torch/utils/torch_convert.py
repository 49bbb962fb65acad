"""PyTorch checkpoint -> Flax-path parameter trees, for the port.

Port of ``vface_tpu/utils/torch_convert.py`` (numpy only; the port keeps its
own copy). The reference ships its weights as torch checkpoints (ArcFace
``model_ir_se50.pth``, BiSeNet ``79999_iter.pth``, torchvision RAFT, the eval
nets' checkpoints); each converter maps such a ``state_dict`` onto the nested
tree of numpy arrays under the Flax paths that the JAX package's converter
gives, bit for bit. The port's modules mirror those paths, so
:func:`vface_torch.utils.convert.from_flax_aux` / ``from_flax_eval`` turn a tree
into the port's state dicts (:func:`aux_state_dicts`, :func:`eval_state_dicts`,
:func:`lpips_state_dict` do both steps), and
:func:`vface_torch.runtime.checkpoint.save_params_npz` writes the tree as the
flat npz that the CLIs' ``--params`` / ``--aux_params`` read.

Layout rules:
* torch Conv2d weight (O, I, kH, kW) -> flax ``kernel`` (kH, kW, I, O)
* torch Linear weight (O, I)         -> flax ``kernel`` (I, O)
* torch norm weight/bias             -> flax ``scale`` / ``bias``
* torch BN running_mean/var          -> FrozenBN ``mean`` / ``var``

Use :func:`verify_tree` to check a converted tree's shapes against another
tree of the same model before saving.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _t(x) -> np.ndarray:
    """torch tensor → numpy (works on torch or numpy inputs)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def conv_kernel(w) -> np.ndarray:
    return _t(w).transpose(2, 3, 1, 0)


def linear_kernel(w) -> np.ndarray:
    return _t(w).transpose(1, 0)


def set_path(tree: Dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def convert_frozen_bn(sd: Mapping, prefix: str, tree: Dict, out_prefix: str) -> None:
    set_path(tree, f"{out_prefix}/scale", _t(sd[f"{prefix}.weight"]))
    set_path(tree, f"{out_prefix}/bias", _t(sd[f"{prefix}.bias"]))
    set_path(tree, f"{out_prefix}/mean", _t(sd[f"{prefix}.running_mean"]))
    set_path(tree, f"{out_prefix}/var", _t(sd[f"{prefix}.running_var"]))


def convert_conv(sd: Mapping, prefix: str, tree: Dict, out_prefix: str, bias=True) -> None:
    set_path(tree, f"{out_prefix}/kernel", conv_kernel(sd[f"{prefix}.weight"]))
    if bias and f"{prefix}.bias" in sd:
        set_path(tree, f"{out_prefix}/bias", _t(sd[f"{prefix}.bias"]))


def convert_linear(sd: Mapping, prefix: str, tree: Dict, out_prefix: str, bias=True) -> None:
    set_path(tree, f"{out_prefix}/kernel", linear_kernel(sd[f"{prefix}.weight"]))
    if bias and f"{prefix}.bias" in sd:
        set_path(tree, f"{out_prefix}/bias", _t(sd[f"{prefix}.bias"]))


def convert_groupnorm(sd: Mapping, prefix: str, tree: Dict, out_prefix: str) -> None:
    set_path(tree, f"{out_prefix}/GroupNorm_0/scale", _t(sd[f"{prefix}.weight"]))
    set_path(tree, f"{out_prefix}/GroupNorm_0/bias", _t(sd[f"{prefix}.bias"]))


def convert_layernorm(sd: Mapping, prefix: str, tree: Dict, out_prefix: str) -> None:
    set_path(tree, f"{out_prefix}/LayerNorm_0/scale", _t(sd[f"{prefix}.weight"]))
    set_path(tree, f"{out_prefix}/LayerNorm_0/bias", _t(sd[f"{prefix}.bias"]))


# --------------------------------------------------------------------- ArcFace


def convert_arcface(sd: Mapping) -> Dict:
    """model_ir_se50.pth → IRSE50 param tree.

    torch layout (model_irse.py): input_layer.{0 conv,1 bn,2 prelu},
    body.{i}.{res_layer.{0 bn,1 conv,2 prelu,3 conv,4 bn,5 se},
    shortcut_layer.{0 conv,1 bn}}, output_layer.{0 bn,3 linear,4 bn1d}.
    """
    tree: Dict = {}
    convert_conv(sd, "input_layer.0", tree, "input_conv", bias=False)
    convert_frozen_bn(sd, "input_layer.1", tree, "input_bn")
    set_path(tree, "input_prelu/alpha", _t(sd["input_layer.2.weight"]))
    i = 0
    while f"body.{i}.res_layer.1.weight" in sd:
        p = f"body.{i}"
        o = f"block_{i}"
        convert_frozen_bn(sd, f"{p}.res_layer.0", tree, f"{o}/bn1")
        convert_conv(sd, f"{p}.res_layer.1", tree, f"{o}/conv1", bias=False)
        set_path(tree, f"{o}/prelu/alpha", _t(sd[f"{p}.res_layer.2.weight"]))
        convert_conv(sd, f"{p}.res_layer.3", tree, f"{o}/conv2", bias=False)
        convert_frozen_bn(sd, f"{p}.res_layer.4", tree, f"{o}/bn2")
        convert_conv(sd, f"{p}.res_layer.5.fc1", tree, f"{o}/se/fc1", bias=False)
        convert_conv(sd, f"{p}.res_layer.5.fc2", tree, f"{o}/se/fc2", bias=False)
        if f"{p}.shortcut_layer.0.weight" in sd:
            convert_conv(sd, f"{p}.shortcut_layer.0", tree, f"{o}/shortcut_conv", bias=False)
            convert_frozen_bn(sd, f"{p}.shortcut_layer.1", tree, f"{o}/shortcut_bn")
        i += 1
    convert_frozen_bn(sd, "output_layer.0", tree, "out_bn")
    convert_linear(sd, "output_layer.3", tree, "out_fc")
    convert_frozen_bn(sd, "output_layer.4", tree, "out_feat_bn")
    return tree


# --------------------------------------------------------------------- BiSeNet


def convert_bisenet(sd: Mapping) -> Dict:
    """79999_iter.pth → BiSeNet param tree (zllrunning face-parsing layout)."""
    tree: Dict = {}

    def cbr(p, o):  # ConvBNReLU
        convert_conv(sd, f"{p}.conv", tree, f"{o}/conv", bias=False)
        convert_frozen_bn(sd, f"{p}.bn", tree, f"{o}/bn")

    # resnet trunk
    convert_conv(sd, "cp.resnet.conv1", tree, "cp/resnet/conv1", bias=False)
    convert_frozen_bn(sd, "cp.resnet.bn1", tree, "cp/resnet/bn1")
    for li, layer in enumerate(["layer1", "layer2", "layer3", "layer4"]):
        for b in range(2):
            p = f"cp.resnet.{layer}.{b}"
            o = f"cp/resnet/{layer}_{b}"
            convert_conv(sd, f"{p}.conv1", tree, f"{o}/conv1", bias=False)
            convert_frozen_bn(sd, f"{p}.bn1", tree, f"{o}/bn1")
            convert_conv(sd, f"{p}.conv2", tree, f"{o}/conv2", bias=False)
            convert_frozen_bn(sd, f"{p}.bn2", tree, f"{o}/bn2")
            if f"{p}.downsample.0.weight" in sd:
                convert_conv(sd, f"{p}.downsample.0", tree, f"{o}/down_conv", bias=False)
                convert_frozen_bn(sd, f"{p}.downsample.1", tree, f"{o}/down_bn")
    # context path
    for arm, o in [("cp.arm16", "cp/arm16"), ("cp.arm32", "cp/arm32")]:
        cbr(f"{arm}.conv", f"{o}/conv")
        convert_conv(sd, f"{arm}.conv_atten", tree, f"{o}/conv_atten", bias=False)
        convert_frozen_bn(sd, f"{arm}.bn_atten", tree, f"{o}/bn_atten")
    cbr("cp.conv_avg", "cp/conv_avg")
    cbr("cp.conv_head32", "cp/conv_head32")
    cbr("cp.conv_head16", "cp/conv_head16")
    # ffm
    cbr("ffm.convblk", "ffm/convblk")
    convert_conv(sd, "ffm.conv1", tree, "ffm/conv1", bias=False)
    convert_conv(sd, "ffm.conv2", tree, "ffm/conv2", bias=False)
    # output head
    cbr("conv_out.conv", "conv_out/conv")
    convert_conv(sd, "conv_out.conv_out", tree, "conv_out/conv_out", bias=False)
    return tree


# ----------------------------------------------- torchvision-style ResNet-50


def convert_resnet50_trunk(sd: Mapping, tree: Dict, src: str = "", out: str = "backbone") -> None:
    """torchvision ResNet-50 (v1.5 Bottleneck) names → `vface_torch.eval.backbones.ResNet50`.

    Layout shared by Hopenet (`eval_tool/face_vid2vid/modules/hopenet.py:7-25`)
    and Deep3DFaceRecon's vendored resnet50
    (`eval_tool/Deep3DFaceRecon_pytorch_edit/models/networks.py:207-308`).
    """
    p = f"{src}." if src else ""
    convert_conv(sd, f"{p}conv1", tree, f"{out}/conv1", bias=False)
    convert_frozen_bn(sd, f"{p}bn1", tree, f"{out}/bn1")
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            tp = f"{p}layer{stage + 1}.{b}"
            to = f"{out}/layer{stage + 1}_{b}"
            for i in (1, 2, 3):
                convert_conv(sd, f"{tp}.conv{i}", tree, f"{to}/conv{i}", bias=False)
                convert_frozen_bn(sd, f"{tp}.bn{i}", tree, f"{to}/bn{i}")
            if f"{tp}.downsample.0.weight" in sd:
                convert_conv(sd, f"{tp}.downsample.0", tree, f"{to}/down_conv", bias=False)
                convert_frozen_bn(sd, f"{tp}.downsample.1", tree, f"{to}/down_bn")


def convert_hopenet(sd: Mapping) -> Dict:
    """Hopenet checkpoint → `vface_torch.eval.pose.Hopenet` tree (fc_finetune is vestigial
    and skipped, hopenet.py:28)."""
    tree: Dict = {}
    convert_resnet50_trunk(sd, tree, src="", out="backbone")
    for head in ("fc_yaw", "fc_pitch", "fc_roll"):
        convert_linear(sd, head, tree, head)
    return tree


def convert_face_recon(sd: Mapping) -> Dict:
    """Deep3DFaceRecon ``net_recon`` (ReconNetWrapper, use_last_fc=False) →
    `vface_torch.eval.expression.FaceReconNet` tree.

    The reference head is seven 1×1 convs over the pooled 2048-d feature
    (networks.py:84-92, order [id, exp, tex, angle, gamma, tx_ty, tz]);
    a 1×1 conv on a 1×1 map is a linear layer, so they concatenate into one
    Dense(257) matching `split_coeff`'s slicing order.
    """
    tree: Dict = {}
    convert_resnet50_trunk(sd, tree, src="backbone", out="backbone")
    kernels, biases = [], []
    for i in range(7):
        w = _t(sd[f"final_layers.{i}.weight"])  # (out, 2048, 1, 1)
        kernels.append(w[:, :, 0, 0].transpose(1, 0))
        biases.append(_t(sd[f"final_layers.{i}.bias"]))
    set_path(tree, "fc/kernel", np.concatenate(kernels, axis=1))
    set_path(tree, "fc/bias", np.concatenate(biases, axis=0))
    return tree


# ------------------------------------------------------------------- LPIPS


def convert_lpips(sd: Mapping) -> Dict:
    """Reference LPIPS module state_dict (eval_tool/lpips/lpips.py: torch
    AlexNet ``net.layers`` + ``lin`` 1×1 weighting convs) →
    `vface_torch.eval.lpips.LPIPS` tree."""
    tree: Dict = {}
    conv_idx = (0, 3, 6, 8, 10)  # torchvision alexnet .features conv positions
    for i, ci in enumerate(conv_idx):
        convert_conv(sd, f"net.layers.{ci}", tree, f"net/conv{i}")
    for i in range(5):
        convert_conv(sd, f"lin.{i}.1", tree, f"lin{i}", bias=False)
    return tree


# ------------------------------------------------------------- FID Inception


_INCEPTION_A = {
    "branch1x1": "b1x1", "branch5x5_1": "b5_1", "branch5x5_2": "b5_2",
    "branch3x3dbl_1": "b3_1", "branch3x3dbl_2": "b3_2", "branch3x3dbl_3": "b3_3",
    "branch_pool": "bpool",
}
_INCEPTION_B = {
    "branch3x3": "b3",
    "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2", "branch3x3dbl_3": "bd_3",
}
_INCEPTION_C = {
    "branch1x1": "b1x1",
    "branch7x7_1": "b7_1", "branch7x7_2": "b7_2", "branch7x7_3": "b7_3",
    "branch7x7dbl_1": "bd_1", "branch7x7dbl_2": "bd_2", "branch7x7dbl_3": "bd_3",
    "branch7x7dbl_4": "bd_4", "branch7x7dbl_5": "bd_5",
    "branch_pool": "bpool",
}
_INCEPTION_D = {
    "branch3x3_1": "b3_1", "branch3x3_2": "b3_2",
    "branch7x7x3_1": "b7_1", "branch7x7x3_2": "b7_2",
    "branch7x7x3_3": "b7_3", "branch7x7x3_4": "b7_4",
}
_INCEPTION_E = {
    "branch1x1": "b1x1",
    "branch3x3_1": "b3_1", "branch3x3_2a": "b3_2a", "branch3x3_2b": "b3_2b",
    "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
    "branch3x3dbl_3a": "bd_3a", "branch3x3dbl_3b": "bd_3b",
    "branch_pool": "bpool",
}
_INCEPTION_BLOCKS = {
    "Mixed_5b": _INCEPTION_A, "Mixed_5c": _INCEPTION_A, "Mixed_5d": _INCEPTION_A,
    "Mixed_6a": _INCEPTION_B,
    "Mixed_6b": _INCEPTION_C, "Mixed_6c": _INCEPTION_C,
    "Mixed_6d": _INCEPTION_C, "Mixed_6e": _INCEPTION_C,
    "Mixed_7a": _INCEPTION_D,
    "Mixed_7b": _INCEPTION_E, "Mixed_7c": _INCEPTION_E,
}


def convert_fid_inception(sd: Mapping) -> Dict:
    """pytorch-fid InceptionV3 checkpoint (`eval_tool/fid/inception.py`,
    torchvision naming: ``Mixed_5b.branch1x1.conv/bn``) →
    `vface_torch.eval.fid.InceptionV3Pool3` tree. FC/aux-classifier keys are unused by the
    pool3 feature tap and skipped."""
    tree: Dict = {}

    def cbn(src_prefix, out_prefix):
        convert_conv(sd, f"{src_prefix}.conv", tree, f"{out_prefix}/conv", bias=False)
        convert_frozen_bn(sd, f"{src_prefix}.bn", tree, f"{out_prefix}/bn")

    for src, out in (
        ("Conv2d_1a_3x3", "Conv2d_1a"), ("Conv2d_2a_3x3", "Conv2d_2a"),
        ("Conv2d_2b_3x3", "Conv2d_2b"), ("Conv2d_3b_1x1", "Conv2d_3b"),
        ("Conv2d_4a_3x3", "Conv2d_4a"),
    ):
        cbn(src, out)
    for block, branch_map in _INCEPTION_BLOCKS.items():
        for src, out in branch_map.items():
            cbn(f"{block}.{src}", f"{block}/{out}")
    return tree


# ----------------------------------------------------------- torchvision RAFT


def _identity_instance_norm(tree: Dict, path: str, ch: int) -> None:
    # torchvision RAFT instance norms are affine-less (InstanceNorm2d default);
    # our InstanceNorm carries scale/bias params — identity-fill them.
    set_path(tree, f"{path}/scale", np.ones((ch,), np.float32))
    set_path(tree, f"{path}/bias", np.zeros((ch,), np.float32))


def _zero_bias(tree: Dict, path: str, ch: int) -> None:
    # torch convs followed by a norm have bias=False; ours default use_bias=True
    set_path(tree, f"{path}/bias", np.zeros((ch,), np.float32))


_RAFT_UNITS = ((64, 1), (64, 1), (96, 2), (96, 1), (128, 2), (128, 1))


def convert_raft(sd: Mapping) -> Dict:
    """torchvision ``raft_large`` state_dict → `vface_torch.models.raft.RAFT` tree.

    The reference loads torchvision's raft_large
    (REFace ``scripts/temporal_flow.py:27-28``). Name map:
    feature_encoder/context_encoder → fnet/cnet (convnormrelu.0 → conv1,
    layer{1..3}.{0,1} → layer_{0..5}, final conv → conv2); update_block's
    motion_encoder/recurrent_block/flow_head + mask_predictor → update.
    Instance norms are affine-less in torch (identity-filled here); convs
    followed by norms have no torch bias (zero-filled; exact under instance
    norm's mean subtraction, and absent from the checkpoint for BN convs).
    """
    tree: Dict = {}
    for enc, out, inorm in (("feature_encoder", "fnet", True), ("context_encoder", "cnet", False)):
        convert_conv(sd, f"{enc}.convnormrelu.0", tree, f"{out}/conv1", bias=True)
        _zero_bias(tree, f"{out}/conv1", 64)
        if inorm:
            _identity_instance_norm(tree, f"{out}/norm1", 64)
        else:
            convert_frozen_bn(sd, f"{enc}.convnormrelu.1", tree, f"{out}/norm1")
        for i, (ch, stride) in enumerate(_RAFT_UNITS):
            layer, blk = 1 + i // 2, i % 2
            tp = f"{enc}.layer{layer}.{blk}"
            to = f"{out}/layer_{i}"
            for j in (1, 2):
                convert_conv(sd, f"{tp}.convnormrelu{j}.0", tree, f"{to}/conv{j}", bias=True)
                _zero_bias(tree, f"{to}/conv{j}", ch)
                if inorm:
                    _identity_instance_norm(tree, f"{to}/norm{j}", ch)
                else:
                    convert_frozen_bn(sd, f"{tp}.convnormrelu{j}.1", tree, f"{to}/norm{j}")
            if f"{tp}.downsample.0.weight" in sd:
                convert_conv(sd, f"{tp}.downsample.0", tree, f"{to}/downsample", bias=True)
                _zero_bias(tree, f"{to}/downsample", ch)
                if inorm:
                    _identity_instance_norm(tree, f"{to}/norm3", ch)
                else:
                    convert_frozen_bn(sd, f"{tp}.downsample.1", tree, f"{to}/norm3")
        convert_conv(sd, f"{enc}.conv", tree, f"{out}/conv2", bias=True)

    me = "update_block.motion_encoder"
    for src, out in (
        (f"{me}.convcorr1.0", "update/motion/convc1"),
        (f"{me}.convcorr2.0", "update/motion/convc2"),
        (f"{me}.convflow1.0", "update/motion/convf1"),
        (f"{me}.convflow2.0", "update/motion/convf2"),
        (f"{me}.conv.0", "update/motion/conv"),
    ):
        convert_conv(sd, src, tree, out)
    rb = "update_block.recurrent_block"
    for gru, ours in (("convgru1", "horiz"), ("convgru2", "vert")):
        for gate in ("z", "r", "q"):
            convert_conv(sd, f"{rb}.{gru}.conv{gate}", tree, f"update/gru/{ours}_{gate}")
    convert_conv(sd, "update_block.flow_head.conv1", tree, "update/flow_head1")
    convert_conv(sd, "update_block.flow_head.conv2", tree, "update/flow_head2")
    convert_conv(sd, "mask_predictor.convrelu.0", tree, "update/mask1")
    convert_conv(sd, "mask_predictor.conv", tree, "update/mask2")
    return tree


# ------------------------------------------------------------------ validation


def verify_tree(converted: Dict, init_tree: Dict, path: str = "") -> list:
    """Return a list of (path, problem) mismatches vs an init tree."""
    problems = []
    for k, v in init_tree.items():
        p = f"{path}/{k}" if path else k
        if k not in converted:
            problems.append((p, "missing"))
        elif isinstance(v, dict):
            problems.extend(verify_tree(converted.get(k, {}), v, p))
        else:
            cv = converted[k]
            if tuple(np.shape(cv)) != tuple(v.shape):
                problems.append((p, f"shape {np.shape(cv)} != {tuple(v.shape)}"))
    for k in converted:
        p = f"{path}/{k}" if path else k
        if k not in init_tree:
            problems.append((p, "unexpected"))
    return problems


# ------------------------------------------------------- the port's state dicts


def aux_state_dicts(state_dicts: Mapping) -> Dict:
    """``{"bisenet": ..., "raft": ...}`` torch state dicts (any subset) -> the
    port's aux-net state dicts, through :func:`vface_torch.utils.convert.from_flax_aux`."""
    from vface_torch.utils.convert import from_flax_aux

    convert = {"bisenet": convert_bisenet, "raft": convert_raft}
    return from_flax_aux({k: convert[k](sd) for k, sd in state_dicts.items()})


def eval_state_dicts(state_dicts: Mapping) -> Dict:
    """``{"inception": ..., "arcface": ..., "hopenet": ..., "facerecon": ...}``
    torch state dicts (any subset) -> the port's eval-net state dicts (what
    ``vface_torch.eval.evaluate_all`` takes), through
    :func:`vface_torch.utils.convert.from_flax_eval`."""
    from vface_torch.utils.convert import from_flax_eval

    convert = {"inception": convert_fid_inception, "arcface": convert_arcface, "hopenet": convert_hopenet,
               "facerecon": convert_face_recon}
    return from_flax_eval({k: convert[k](sd) for k, sd in state_dicts.items()})


def lpips_state_dict(sd: Mapping) -> Dict:
    """The reference LPIPS state dict -> the state dict of :class:`vface_torch.eval.lpips.LPIPS`."""
    from vface_torch.utils.convert import flax_tree_to_state_dict

    return flax_tree_to_state_dict(convert_lpips(sd))
