"""The port's ops: the counterparts of ``vface_tpu.ops``' exports.

``vface_torch.ops.flash_attention`` is a submodule (the attention kernels'
wrappers), so the JAX package's ``flash_attention`` (the k-tiled v1, K8) is
exported here as ``flash_attention_v1``. ``geglu_ff_wide`` (K9) is the port's
entry point to the wide GEGLU kernel, which the JAX package keeps unwired.
"""

from vface_torch.ops.attention import FlowPack, FusionConfig, fuse_qkv, multi_head_attention
from vface_torch.ops.flash_attention import flash_attention_v1, flash_attention_v2
from vface_torch.ops.fusion import (
    adain_fusion,
    adain_fusion_attn,
    combine_fft_high_low,
    combine_fft_high_low_circulant,
    fft_fusion,
    gaussian_blur,
    lpf_fusion,
    mix,
    temporal_gaussian,
)
from vface_torch.ops.geglu_ff import geglu_ff_wide
from vface_torch.ops.warp import (
    align_by_flow,
    align_by_flow_chain,
    align_by_flow_high_res,
    batch_flow_align,
    batch_flow_align_latent,
    grid_sample,
    resize_flow,
    warp_by_flow,
    warp_from_video,
)

__all__ = [
    "FlowPack",
    "FusionConfig",
    "fuse_qkv",
    "multi_head_attention",
    "adain_fusion",
    "adain_fusion_attn",
    "combine_fft_high_low",
    "combine_fft_high_low_circulant",
    "fft_fusion",
    "gaussian_blur",
    "lpf_fusion",
    "mix",
    "temporal_gaussian",
    "flash_attention_v1",
    "flash_attention_v2",
    "geglu_ff_wide",
    "align_by_flow",
    "align_by_flow_chain",
    "align_by_flow_high_res",
    "batch_flow_align",
    "batch_flow_align_latent",
    "grid_sample",
    "resize_flow",
    "warp_by_flow",
    "warp_from_video",
]
