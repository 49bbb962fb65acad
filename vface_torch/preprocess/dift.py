"""DIFT: diffusion-feature correspondences between a source and a target face, PyTorch.

Port of ``vface_tpu/preprocess/dift.py`` (REFace's ``scripts/make_priors.py``
with DIFT's ``SDFeaturizer``; Tang et al., "Emergent Correspondence from Image
Diffusion", 2023): an output block's UNet feature map for each image at a
fixed noise level, then each target location matched to the source location of
highest cosine similarity, giving a "prior" image that carries the source's
appearance into the target's geometry.

Both images ride one batched UNet forward (b = 2 at SD-v1 widths, through the
attention, GEGLU and GroupNorm kernels on the card); the match is one
(h*w, h*w) similarity product and an argmax. JAX draws the latent noise from
``PRNGKey(0)``, which torch cannot replay: :func:`dift_features` takes the
noise as a tensor, or draws it from a CPU generator seeded with 0, so that
every device draws the same noise.
"""

from __future__ import annotations

from typing import Optional

import torch

from vface_torch.ops.warp import resize_nearest


@torch.inference_mode()
def dift_features(model, images: torch.Tensor, cond: torch.Tensor, t: int = 261, block: int = -4,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, h, w, C) feature maps of ``model``'s UNet output block ``block``.

    ``images`` (B, S, S, 3) in [-1, 1]; ``cond`` (B, 1, D) the conditioning;
    ``t`` DIFT's SD timestep; ``noise`` the latent-shaped standard normal draw
    (B, h, h, 4) at the model's latent size, else drawn on the CPU from seed 0."""
    dev = next(model.parameters()).device
    images = torch.as_tensor(images, device=dev)
    b = images.shape[0]
    hl = model.cfg.latent_size
    z = model.encode_first_stage(images).to(torch.float32)
    if noise is None:
        noise = torch.randn(z.shape, generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    tt = torch.full((b,), t, dtype=torch.long, device=dev)
    z_t = model.q_sample(z, tt, torch.as_tensor(noise, device=dev, dtype=torch.float32))
    # neutral inpaint channels: the full image and a keep-all mask
    x9 = model.build_unet_input(z_t, z, torch.ones((b, hl, hl, 1), device=dev))
    _, feats = model.apply_model(x9, tt, torch.as_tensor(cond, device=dev), return_features=True)
    return feats[block]


def similarity(feat_tar: torch.Tensor, feat_src: torch.Tensor) -> torch.Tensor:
    """The cosine similarities (h*w target locations, h*w source locations) in float32."""
    c = feat_tar.shape[-1]
    ft = feat_tar.reshape(-1, c).to(torch.float32)
    fs = feat_src.reshape(-1, c).to(torch.float32)
    ft = ft / (torch.linalg.vector_norm(ft, dim=-1, keepdim=True) + 1e-8)
    fs = fs / (torch.linalg.vector_norm(fs, dim=-1, keepdim=True) + 1e-8)
    return ft @ fs.T


def correspondences(feat_tar: torch.Tensor, feat_src: torch.Tensor) -> torch.Tensor:
    """feat_* (h, w, C) -> (h, w, 2) int32: for each target location the (x, y)
    of the source location of highest cosine similarity."""
    h, w, _ = feat_tar.shape
    idx = torch.argmax(similarity(feat_tar, feat_src), dim=-1)
    return torch.stack([idx % w, idx // w], dim=-1).reshape(h, w, 2).to(torch.int32)


def prior_from_correspondences(source: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """``source`` (S, S, 3) gathered through feature-grid correspondences
    ``corr`` (h, w, 2), upsampled to the pixel grid with JAX's nearest rule
    (half-pixel centres) and scaled by S // h: the prior (S, S, 3)."""
    s = source.shape[0]
    scale = s // corr.shape[0]
    corr_px = resize_nearest(corr.to(torch.float32)[None], s, s)[0] * scale
    xi = corr_px[..., 0].to(torch.int32).clamp(0, s - 1).long()
    yi = corr_px[..., 1].to(torch.int32).clamp(0, s - 1).long()
    return source[yi, xi]


def make_prior(model, target: torch.Tensor, source: torch.Tensor, cond: torch.Tensor, t: int = 261,
               block: int = -4, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp the source's appearance into the target's geometry: the prior image
    (S, S, 3) from ``target`` and ``source`` (S, S, 3) in [-1, 1] and ``cond``
    (2, 1, D) for [target, source], through :func:`dift_features` (one b = 2
    forward), :func:`correspondences` and :func:`prior_from_correspondences`."""
    dev = next(model.parameters()).device
    target, source = torch.as_tensor(target, device=dev), torch.as_tensor(source, device=dev)
    feats = dift_features(model, torch.stack([target, source]), cond, t=t, block=block, noise=noise)
    return prior_from_correspondences(source, correspondences(feats[0], feats[1]))
