"""The benchmark reference's frozen copy of ``vface_torch/models/clip.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

CLIP ViT-L/14 vision and text towers and the REFace conditioning mapper, PyTorch.

Port of ``vface_tpu/models/clip.py``. Vision side: the HF
``CLIPVisionModel`` pooled output (post-LN CLS token) -> ``visual_projection``
(width -> 768, no bias) -> ``mapper2``, five width-768 single-head pre-LN
transformer blocks on the one token -> ``final_ln2``. Output: one float32
conditioning token per image, (B, 1, 768).

Quick-GELU in the tower, exact (erf) GELU in the mapper; LayerNorms reduce and
apply in float32; the matmuls run in ``cfg.dtype`` (float32 by default, as
the JAX config's). Parameter names mirror the Flax tree (``vision.layer_3.
attn.q.weight`` is ``vision/layer_3/attn/q/kernel``).

Text side (:class:`CLIPTextTower`, :class:`CLIPTextEncoder`, the HF
``CLIPTextModel`` of REFace's ``FrozenCLIPTextEmbedder``): token + position
embeddings, a causally masked pre-LN transformer, the final LN; the pooled
state is each row's first EOS token. Its ids come from
:class:`vface_torch.models.clip_tokenizer.CLIPBPETokenizer`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv, Dense, LayerNormF32
from benchmark.reference.attention import multi_head_attention
from benchmark.reference.warp import resize_bilinear

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x.to(torch.float32)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    projection_dim: int = 768
    dtype: torch.dtype = torch.float32

    @classmethod
    def vit_l_14(cls, dtype=torch.bfloat16):
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls):
        return cls(image_size=32, patch_size=8, width=64, layers=2, heads=4, projection_dim=64)


class MHA(nn.Module):
    """Multi-head self-attention with separate q/k/v/out projections (with bias)."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.q = Dense(width, width, dtype=dtype)
        self.k = Dense(width, width, dtype=dtype)
        self.v = Dense(width, width, dtype=dtype)
        self.out = Dense(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(multi_head_attention(self.q(x), self.k(x), self.v(x), self.heads))


class EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: int, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNormF32(width)
        self.attn = MHA(width, heads, dtype=dtype)
        self.ln2 = LayerNormF32(width)
        self.fc1 = Dense(width, width * mlp_ratio, dtype=dtype)
        self.fc2 = Dense(width * mlp_ratio, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPVisionTower(nn.Module):
    """HF CLIPVisionModel semantics on NHWC pixels: returns the pooled embedding (B, width)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = Conv(3, cfg.width, kernel=cfg.patch_size, stride=cfg.patch_size, padding=0,
                                dtype=cfg.dtype, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.position_embedding = nn.Parameter(torch.zeros(n_patches + 1, cfg.width))
        self.pre_ln = LayerNormF32(cfg.width)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg.width, cfg.heads, cfg.mlp_ratio, dtype=cfg.dtype))
        self.post_ln = LayerNormF32(cfg.width)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        x = self.patch_embed(pixels.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, width), row-major over the patch grid
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)[None]
        x = self.pre_ln(x)
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.post_ln(x[:, 0])


class MapperBlock(nn.Module):
    """Pre-LN attention + pre-LN 4x MLP with exact (erf) GELU in float32."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNormF32(width)
        self.attn = MHA(width, heads, dtype=dtype)
        self.ln2 = LayerNormF32(width)
        self.fc1 = Dense(width, width * 4, dtype=dtype)
        self.fc2 = Dense(width * 4, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)).to(torch.float32)).to(self.dtype)
        return x + self.fc2(h)


class CLIPConditioner(nn.Module):
    """Vision tower -> visual_projection -> mapper2 (5 blocks) -> final_ln2: (B, 1, projection_dim) float32."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), mapper_layers: int = 5):
        super().__init__()
        self.cfg = cfg
        self.mapper_layers = mapper_layers
        self.vision = CLIPVisionTower(cfg)
        self.visual_projection = Dense(cfg.width, cfg.projection_dim, bias=False, dtype=cfg.dtype)
        for i in range(mapper_layers):
            self.add_module(f"mapper2_{i}", MapperBlock(cfg.projection_dim, heads=1, dtype=cfg.dtype))
        self.final_ln2 = LayerNormF32(cfg.projection_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        z = self.visual_projection(self.vision(pixels))[:, None, :]
        for i in range(self.mapper_layers):
            z = getattr(self, f"mapper2_{i}")(z)
        return self.final_ln2(z).to(torch.float32)


def clip_preprocess(images01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> CLIP-normalised (B, size, size, 3); the
    bilinear resize does not antialias (torchvision's resize in the reference)."""
    x = resize_bilinear(images01, size, size, antialias=False)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
