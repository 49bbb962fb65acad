"""CLIP ViT-L/14 vision and text towers and the REFace conditioning mapper, PyTorch.

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

from vface_torch.models.layers import Conv, Dense, LayerNormF32
from vface_torch.ops.attention import multi_head_attention
from vface_torch.ops.warp import resize_bilinear

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

    def forward(self, x: torch.Tensor, bias: torch.Tensor = None) -> torch.Tensor:
        o = multi_head_attention(self.q(x), self.k(x), self.v(x), self.heads, dtype=self.dtype, bias=bias)
        return self.out(o)


class EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: int, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNormF32(width)
        self.attn = MHA(width, heads, dtype=dtype)
        self.ln2 = LayerNormF32(width)
        self.fc1 = Dense(width, width * mlp_ratio, dtype=dtype)
        self.fc2 = Dense(width * mlp_ratio, width, dtype=dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), bias=bias)
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


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """HF ``CLIPTextModel`` geometry (ViT-L/14 text tower defaults)."""

    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 768
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls):
        return cls(vocab_size=64, max_length=16, width=32, layers=2, heads=2, projection_dim=24, eos_token_id=63)


class CLIPTextTower(nn.Module):
    """ids (B, L) int -> (last_hidden_state (B, L, width), pooled (B, width)), float32.

    ``pad_mask`` (B, L) marks real tokens with 1 (the tokenizer's
    ``attention_mask``): padded keys are masked out of every attention row, on
    top of the causal mask (both additive -1e9 on the float32 logits, as
    JAX's). ``pooled`` is the final-LN state at each row's first EOS token."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.width))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg.width, cfg.heads, cfg.mlp_ratio, dtype=cfg.dtype))
        self.final_ln = LayerNormF32(cfg.width)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor = None):
        cfg = self.cfg
        dt = cfg.dtype
        ids = ids.to(device=self.token_embedding.device, dtype=torch.long)
        b, n = ids.shape
        x = self.token_embedding[ids].to(dt) + self.position_embedding[:n].to(dt)[None]
        ar = torch.arange(n, device=ids.device)
        neg = torch.tensor(-1e9, dtype=torch.float32, device=ids.device)
        zero = torch.zeros((), dtype=torch.float32, device=ids.device)
        bias = torch.where(ar[:, None] >= ar[None, :], zero, neg)[None, None]
        if pad_mask is not None:
            pad = torch.as_tensor(pad_mask, device=ids.device)
            bias = bias + torch.where(pad > 0, zero, neg)[:, None, None, :]
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x, bias=bias)
        x = self.final_ln(x)
        eos_pos = torch.argmax((ids == cfg.eos_token_id).to(torch.int32), dim=1)  # the first EOS
        pooled = x[torch.arange(b, device=ids.device), eos_pos]
        return x.to(torch.float32), pooled.to(torch.float32)


class CLIPTextEncoder(nn.Module):
    """:class:`CLIPTextTower` plus the bias-free ``text_projection`` into the
    shared CLIP space: ids -> (hidden, pooled, projected), float32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text = CLIPTextTower(cfg)
        self.text_projection = Dense(cfg.width, cfg.projection_dim, bias=False, dtype=cfg.dtype)

    def forward(self, ids: torch.Tensor, pad_mask: torch.Tensor = None):
        hidden, pooled = self.text(ids, pad_mask=pad_mask)
        return hidden, pooled, self.text_projection(pooled.to(self.cfg.dtype)).to(torch.float32)


def clip_similarity_logits(text_embeds: torch.Tensor, image_embeds: torch.Tensor, logit_scale) -> torch.Tensor:
    """Cosine-similarity logits, exp(logit_scale) * (v / |v|) @ (t / |t|)^T:
    logits_per_image (B_img, B_txt)."""
    t = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True)
    v = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1, keepdim=True)
    return torch.exp(torch.as_tensor(logit_scale, dtype=v.dtype, device=v.device)) * (v @ t.T)


class CLIPImageEmbedderLegacy(nn.Module):
    """The 1024-d variant (REFace's ``FrozenCLIPImageEmbedder``): the pooled
    vision feature -> 5 width-1024 mapper blocks -> ``final_ln``, with no
    ``visual_projection``; (B, 1, width) float32."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), mapper_layers: int = 5):
        super().__init__()
        self.cfg = cfg
        self.mapper_layers = mapper_layers
        self.vision = CLIPVisionTower(cfg)
        for i in range(mapper_layers):
            self.add_module(f"mapper_{i}", MapperBlock(cfg.width, heads=1, dtype=cfg.dtype))
        self.final_ln = LayerNormF32(cfg.width)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        z = self.vision(pixels)[:, None, :]
        for i in range(self.mapper_layers):
            z = getattr(self, f"mapper_{i}")(z)
        return self.final_ln(z).to(torch.float32)
