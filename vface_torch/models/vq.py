"""VQ first-stage models (legacy REFace alternatives), PyTorch.

Port of ``vface_tpu/models/vq.py`` (REFace's ``VQModel`` /
``VQModelInterface``, ``ldm/models/autoencoder.py:14-283``): the
vector-quantised first stage kept for configs that predate the KL
autoencoder. It shares the VAE's :class:`~vface_torch.models.vae.Encoder` /
:class:`~vface_torch.models.vae.Decoder` (so its big GroupNorms take their
statistics from K3 on the card) and adds the codebook with straight-through
quantisation (taming-transformers ``VectorQuantizer2``: the nearest codebook
entry by L2, commitment loss beta = 0.25).

``VQModelInterface`` semantics: :meth:`VQModel.encode` returns the pre-quant
latent; :meth:`VQModel.decode` quantises first unless ``force_not_quantize``.
Images and latents are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from vface_torch.models.layers import Conv
from vface_torch.models.vae import Decoder, Encoder, VAEConfig


@dataclasses.dataclass(frozen=True)
class VQConfig:
    vae: VAEConfig = dataclasses.field(default_factory=lambda: dataclasses.replace(VAEConfig(), double_z=False))
    n_embed: int = 8192
    embed_dim: int = 4
    beta: float = 0.25

    @classmethod
    def tiny(cls):
        return cls(vae=dataclasses.replace(VAEConfig.tiny(), double_z=False), n_embed=64, embed_dim=4)


def codebook_distances(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, n_embed) of rows (N, D) to the codebook
    (n_embed, D), expanded as |z|^2 - 2 z.e + |e|^2 (JAX's form)."""
    return ((flat**2).sum(dim=1, keepdim=True) - 2 * flat @ codebook.T + (codebook**2).sum(dim=1)[None])


class VectorQuantizer(nn.Module):
    """z (..., D) -> (z_q straight-through, the codebook + commitment loss, indices (...))."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.embed_dim = embed_dim
        self.beta = beta
        self.embedding = nn.Parameter(torch.zeros(n_embed, embed_dim))

    def forward(self, z: torch.Tensor):
        flat = z.reshape(-1, self.embed_dim)
        idx = torch.argmin(codebook_distances(flat, self.embedding), dim=1)
        zq = self.embedding[idx].reshape(z.shape)
        loss = self.beta * torch.mean((zq.detach() - z) ** 2) + torch.mean((zq - z.detach()) ** 2)
        zq = z + (zq - z).detach()  # straight-through
        return zq, loss, idx.reshape(z.shape[:-1])


class VQModel(nn.Module):
    """``encode`` (NHWC image -> pre-quant latent), ``decode`` (latent -> NHWC
    image), ``forward`` (image -> (reconstruction, codebook loss))."""

    def __init__(self, cfg: VQConfig = VQConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.vae)
        self.decoder = Decoder(cfg.vae)
        self.quant_conv = Conv(cfg.vae.z_channels, cfg.embed_dim, kernel=1)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.vae.z_channels, kernel=1)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim, cfg.beta)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x.to(self.cfg.vae.dtype).permute(0, 3, 1, 2).contiguous())
        return self.quant_conv(h).permute(0, 2, 3, 1)

    def _decode(self, quant: torch.Tensor) -> torch.Tensor:
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2).contiguous())
        return self.decoder(h).permute(0, 2, 3, 1)

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        quant = h if force_not_quantize else self.quantize(h)[0]
        return self._decode(quant)

    def forward(self, x: torch.Tensor):
        quant, emb_loss, _ = self.quantize(self.encode(x))
        return self._decode(quant), emb_loss
