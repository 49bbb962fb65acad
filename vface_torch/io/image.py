"""PNG frames: read and write 8-bit images through PIL, as the JAX package's CLI does."""

from __future__ import annotations

import numpy as np


def read_png(path: str, mode=None) -> np.ndarray:
    """An image file -> uint8 (H, W[, C]); ``mode`` ("RGB", "L") converts as PIL does."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert(mode) if mode else img)


def write_png(path: str, img_u8) -> None:
    """uint8 (H, W, 3) RGB or (H, W) gray -> a PNG file."""
    from PIL import Image

    a = np.asarray(img_u8)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[-1] == 3)):
        raise ValueError(f"a PNG frame must be (H, W, 3) or (H, W) uint8, got {a.dtype} {a.shape}")
    Image.fromarray(a).save(path)
