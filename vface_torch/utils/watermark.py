"""The invisible watermark and the safety gate of the image CLI.

Port of ``vface_tpu/utils/watermark.py``:

* :func:`embed_watermark` / :func:`extract_watermark`: a byte payload
  ("StableDiffusionV1" by default) in the blue channel's 8x8 DCT blocks, one
  bit a block as the order of two mid-frequency coefficients (Koch-Zhao);
  numpy only, bit-equal to the JAX package's;
* :class:`SafetyChecker`: the Stable Diffusion safety checker's decision over
  the port's CLIP vision tower: the pooled embedding through
  ``visual_projection``, cosines against the special-care and concept
  embeddings less their thresholds, a stricter bar (0.01) for images past a
  special-care concept, and flagged images replaced by black.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEFAULT_PAYLOAD = b"StableDiffusionV1"


def _dct_mat(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m.astype(np.float64)


_DCT = _dct_mat()
_C1, _C2 = (3, 1), (1, 3)  # the mid-frequency coefficient pair
_MARGIN = 10.0


def _bits(payload: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload, np.uint8))


def _embed_block(blk: np.ndarray, bit: int, margin: float) -> np.ndarray:
    d = _DCT @ blk @ _DCT.T
    m = 0.5 * (d[_C1] + d[_C2])
    half = margin / 2
    if bit:
        d[_C1], d[_C2] = m + half, m - half
    else:
        d[_C1], d[_C2] = m - half, m + half
    return _DCT.T @ d @ _DCT


def _read_block_bit(blk: np.ndarray) -> int:
    d = _DCT @ blk @ _DCT.T
    return 1 if d[_C1] > d[_C2] else 0


def embed_watermark(img_u8: np.ndarray, payload: bytes = DEFAULT_PAYLOAD) -> np.ndarray:
    """Embed ``payload`` into the blue channel's 8x8 DCT blocks, row-major; img
    (H, W, 3) uint8 -> uint8. Each block is read back after the uint8
    rounding and embedded again at twice the margin if its bit flipped (at
    most 3 passes)."""
    bits = _bits(payload)
    out = img_u8.copy()
    h8, w8 = out.shape[0] // 8, out.shape[1] // 8
    if h8 * w8 < len(bits):
        raise ValueError(f"image too small for {len(payload)}-byte payload")
    for bi, bit in enumerate(bits):
        by, bx = divmod(bi, w8)
        sl = (slice(by * 8, by * 8 + 8), slice(bx * 8, bx * 8 + 8), 2)
        margin = _MARGIN
        for _ in range(3):
            blk = _embed_block(out[sl].astype(np.float64), int(bit), margin)
            out[sl] = np.clip(np.round(blk), 0, 255).astype(np.uint8)
            if _read_block_bit(out[sl].astype(np.float64)) == int(bit):
                break
            margin *= 2.0
    return out


def extract_watermark(img_u8: np.ndarray, n_bytes: int = len(DEFAULT_PAYLOAD)) -> bytes:
    """Recover an ``n_bytes`` payload embedded by :func:`embed_watermark`."""
    ch = img_u8[..., 2].astype(np.float64)
    h8, w8 = ch.shape[0] // 8, ch.shape[1] // 8
    n_bits = min(n_bytes * 8, h8 * w8)
    bits = [_read_block_bit(ch[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8])
            for by, bx in (divmod(bi, w8) for bi in range(n_bits))]
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


class SafetyChecker:
    """The safety checker's decision over the port's CLIP vision tower (CUDA
    unless asked otherwise).

    ``check(params, images01)`` takes ``{"clip": the tower's state dict,
    "visual_projection": (width, P), "concept_embeds": (C, P),
    "concept_thresholds": (C,), "special_care_embeds": (S, P),
    "special_care_thresholds": (S,)}`` (:func:`vface_torch.utils.convert.from_flax_safety`
    converts the JAX package's tree) and images (B, H, W, 3) in [0, 1]; returns
    (the images with the flagged ones black, the flags (B,)) as numpy.
    """

    def __init__(self, vision_cfg=None, device="cuda"):
        from vface_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
        from vface_torch.utils.platform import resolve_device

        self.cfg = vision_cfg or CLIPVisionConfig()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.tower = CLIPVisionTower(self.cfg).eval()

    @staticmethod
    def _cos(a, b):
        a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)
        b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-8)
        return a @ b.T

    @torch.inference_mode()
    def check(self, params: dict, images01, adjustment: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        from vface_torch.models.clip import clip_preprocess

        self.tower.load_state_dict(params["clip"])
        images = np.array(images01.cpu() if isinstance(images01, torch.Tensor) else images01, np.float32)
        px = clip_preprocess(torch.from_numpy(images).to(self.device), self.cfg.image_size)
        pooled = self.tower(px).float().cpu().numpy()
        arr = lambda k: np.asarray(params[k], np.float32)
        emb = pooled @ arr("visual_projection")
        special = self._cos(emb, arr("special_care_embeds")) - (arr("special_care_thresholds") + adjustment)
        strict = (special > 0).any(axis=-1, keepdims=True) * 0.01
        concept = self._cos(emb, arr("concept_embeds")) - (arr("concept_thresholds") + adjustment - strict)
        has_nsfw = (concept > 0).any(axis=-1)
        checked = images.copy()
        checked[has_nsfw] = 0.0
        return checked, has_nsfw
