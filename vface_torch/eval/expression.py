"""Expression metric: the 3DMM expression-coefficient L2 (port of ``vface_tpu/eval/expression.py``).

Deep3DFaceRecon's ``net_recon``, a ResNet-50 regressing the 257-d BFM09
coefficient vector; the metric is the L2 distance between the expression
slices ``coeff[80:144]`` of swapped and target crops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from vface_torch.eval._common import eval_net, extract
from vface_torch.eval.backbones import ResNet50
from vface_torch.models.layers import Dense
from vface_torch.ops.warp import resize_bilinear

# the BFM09 coefficient layout
ID_SLICE = slice(0, 80)
EXP_SLICE = slice(80, 144)
TEX_SLICE = slice(144, 224)
ANGLE_SLICE = slice(224, 227)
GAMMA_SLICE = slice(227, 254)
TRANS_SLICE = slice(254, 257)


class FaceReconNet(nn.Module):
    """(B, 224, 224, 3) NHWC in [0, 1] -> 257 BFM coefficients."""

    def __init__(self, coeffs: int = 257):
        super().__init__()
        self.backbone = ResNet50()
        self.fc = Dense(2048, coeffs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.backbone(x))


def face_coeffs(params, images01, model=None, batch: int = 32, device="cuda") -> np.ndarray:
    """[0, 1] face crops -> (B, 257) coefficients (224^2, bilinear and
    antialiased, [0, 1] RGB: Deep3DFaceRecon's convention); ``params`` a
    ``FaceReconNet`` state dict."""
    net = eval_net(FaceReconNet, model if model is not None else params, device)
    return extract(lambda x: net(resize_bilinear(x, 224, 224)), images01, batch, net)


def expression_l2(coeffs_a: np.ndarray, coeffs_b: np.ndarray) -> float:
    ea = np.asarray(coeffs_a)[:, EXP_SLICE]
    eb = np.asarray(coeffs_b)[:, EXP_SLICE]
    return float(np.linalg.norm(ea - eb, axis=-1).mean())
