"""The benchmark reference's frozen copy of ``vface_torch/preprocess/masks.py``: plain PyTorch,
float32, no kernel; it imports nothing of the program. What follows is the
original's description.

Segmentation-mask semantics: the CelebAMask-HQ 19-class and FFHQ 12-class tables.

Port of ``vface_tpu/preprocess/masks.py``. Every lookup is a table gather over
an integer class map, so it runs batched on any device.
"""

from __future__ import annotations

from typing import Sequence

import torch

# CelebAMask-HQ 19 classes:
# 0 background, 1 skin, 2 l_brow, 3 r_brow, 4 l_eye, 5 r_eye, 6 eye_g,
# 7 l_ear, 8 r_ear, 9 ear_r, 10 nose, 11 mouth, 12 u_lip, 13 l_lip,
# 14 neck, 15 neck_l, 16 cloth, 17 hair, 18 hat
CELEBA_CLASSES = 19

# the face-region classes removed for the inpaint region at training: skin,
# brows, eyes, glasses, ears, earring, nose, mouth, lips, hair
TRAIN_REMOVE = (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12, 17)

# 12-class FFHQ scheme: classes kept as background (not regenerated)
FFHQ12_PRESERVE = (1, 2, 3, 5, 6, 7, 9)

# 19 -> 12 conversion: celeba id -> seg12 id
_CELEBA_TO_SEG12 = [0, 10, 2, 2, 4, 4, 3, 8, 8, 8, 6, 9, 9, 9, 7, 7, 11, 1, 5]


def celeba_to_seg12(mask: torch.Tensor) -> torch.Tensor:
    """Integer 19-class index map -> the 12-class scheme (int32)."""
    table = torch.tensor(_CELEBA_TO_SEG12, dtype=torch.int32, device=mask.device)
    return table[mask.long()]


def region_mask(mask: torch.Tensor, classes: Sequence[int], num_classes: int = CELEBA_CLASSES) -> torch.Tensor:
    """float32 mask, 1 where the pixel's class is in ``classes``."""
    table = torch.zeros(num_classes, dtype=torch.float32, device=mask.device)
    table[list(classes)] = 1.0
    return table[mask.long()]


def inpaint_inputs(image: torch.Tensor, mask: torch.Tensor, remove: Sequence[int] = TRAIN_REMOVE):
    """(inpaint_image, inpaint_mask) as the datasets build them.

    image (B, H, W, 3) in [-1, 1]; mask (B, H, W) class indices. The inpaint
    mask is 1 where content is kept (the face region is zeroed).
    """
    keep = (1.0 - region_mask(mask, remove))[..., None]
    return image * keep, keep


def preserve_mask_seg12(mask12: torch.Tensor, preserve: Sequence[int] = FFHQ12_PRESERVE) -> torch.Tensor:
    """1 where the 12-class id is in the preserve list (stays original)."""
    return region_mask(mask12, preserve, num_classes=12)


def downsample_mask_to_latent(mask: torch.Tensor, latent_size: int) -> torch.Tensor:
    """(B, H, W, 1) float mask -> (B, h, h, 1) by area pooling."""
    b, h, w, c = mask.shape
    fh, fw = h // latent_size, w // latent_size
    return mask.reshape(b, latent_size, fh, latent_size, fw, c).mean(dim=(2, 4))
