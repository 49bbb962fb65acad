"""Host-side data loading; for now the precomputed parse-map masks.

Port of ``_load_mask`` from ``vface_tpu/data/datasets.py`` (the rest of that
module, the training datasets, is ROADMAP A12).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _load_mask(path: str, size: Optional[int] = None) -> np.ndarray:
    """A parse-map PNG (class ids as pixel values) -> int32 (H, W), resized to
    (size, size) by nearest neighbour (PIL's, as the JAX package's loader)."""
    from PIL import Image

    with Image.open(path) as img:
        if size is not None:
            img = img.resize((size, size), Image.NEAREST)
        return np.asarray(img).astype(np.int32)
