"""FID, the Frechet Inception Distance (port of ``vface_tpu/eval/fid.py``).

InceptionV3's pool3 (2048-d) activations over a result set and a reference
set, then d^2 = |mu1 - mu2|^2 + tr(C1 + C2 - 2 sqrt(C1 C2)), the matrix root's
trace from the eigenvalues of the symmetric C1^1/2 C2 C1^1/2 (numpy ``eigh``,
a copy of the JAX package's function). The network follows the torchvision
topology the FID net uses: ``ConvBN`` on frozen BatchNorm with eps 1e-3,
``InceptionA``-``E``, average pools that leave the padding out of the count,
and ``Mixed_7c`` pooling by max. Its parameter names mirror the Flax module's
(:func:`vface_torch.utils.convert.from_flax_eval`). FID values compare only
with the same converted weights, as for any FID implementation. float32,
NHWC at the boundary.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vface_torch.eval._common import eval_net, extract
from vface_torch.models.arcface import FrozenBN
from vface_torch.models.layers import Conv
from vface_torch.ops.warp import resize_bilinear


class ConvBN(nn.Module):
    """Bias-free conv, frozen BN (eps 1e-3), ReLU. NCHW."""

    def __init__(self, in_ch: int, ch: int, kernel: Tuple[int, int] = (3, 3), stride: int = 1,
                 padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = Conv(in_ch, ch, kernel=kernel, stride=stride, padding=tuple(padding), bias=False)
        self.bn = FrozenBN(ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_ch: int):
        super().__init__()
        self.b1x1 = ConvBN(in_ch, 64, (1, 1))
        self.b5_1 = ConvBN(in_ch, 48, (1, 1))
        self.b5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2))
        self.b3_1 = ConvBN(in_ch, 64, (1, 1))
        self.b3_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.b3_3 = ConvBN(96, 96, (3, 3), padding=(1, 1))
        self.bpool = ConvBN(in_ch, pool_ch, (1, 1))

    def forward(self, x):
        return torch.cat([self.b1x1(x), self.b5_2(self.b5_1(x)), self.b3_3(self.b3_2(self.b3_1(x))),
                          self.bpool(_avg3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.b3 = ConvBN(in_ch, 384, (3, 3), stride=2)
        self.bd_1 = ConvBN(in_ch, 64, (1, 1))
        self.bd_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.bd_3 = ConvBN(96, 96, (3, 3), stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.bd_3(self.bd_2(self.bd_1(x))), F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, ch7: int):
        super().__init__()
        c = ch7
        self.b1x1 = ConvBN(in_ch, 192, (1, 1))
        self.b7_1 = ConvBN(in_ch, c, (1, 1))
        self.b7_2 = ConvBN(c, c, (1, 7), padding=(0, 3))
        self.b7_3 = ConvBN(c, 192, (7, 1), padding=(3, 0))
        self.bd_1 = ConvBN(in_ch, c, (1, 1))
        self.bd_2 = ConvBN(c, c, (7, 1), padding=(3, 0))
        self.bd_3 = ConvBN(c, c, (1, 7), padding=(0, 3))
        self.bd_4 = ConvBN(c, c, (7, 1), padding=(3, 0))
        self.bd_5 = ConvBN(c, 192, (1, 7), padding=(0, 3))
        self.bpool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        bd = self.bd_5(self.bd_4(self.bd_3(self.bd_2(self.bd_1(x)))))
        return torch.cat([self.b1x1(x), self.b7_3(self.b7_2(self.b7_1(x))), bd, self.bpool(_avg3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.b3_1 = ConvBN(in_ch, 192, (1, 1))
        self.b3_2 = ConvBN(192, 320, (3, 3), stride=2)
        self.b7_1 = ConvBN(in_ch, 192, (1, 1))
        self.b7_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.b7_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.b7_4 = ConvBN(192, 192, (3, 3), stride=2)

    def forward(self, x):
        return torch.cat([self.b3_2(self.b3_1(x)), self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """pool "avg": FIDInceptionE_1 (Mixed_7b); "max": FIDInceptionE_2 (Mixed_7c)."""

    def __init__(self, in_ch: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.b1x1 = ConvBN(in_ch, 320, (1, 1))
        self.b3_1 = ConvBN(in_ch, 384, (1, 1))
        self.b3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bd_1 = ConvBN(in_ch, 448, (1, 1))
        self.bd_2 = ConvBN(448, 384, (3, 3), padding=(1, 1))
        self.bd_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.bd_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bpool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = self.b3_1(x)
        bd = self.bd_2(self.bd_1(x))
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg3(x)
        return torch.cat([self.b1x1(x), self.b3_2a(b3), self.b3_2b(b3), self.bd_3a(bd), self.bd_3b(bd),
                          self.bpool(bp)], dim=1)


class InceptionV3Pool3(nn.Module):
    """(B, 299, 299, 3) NHWC in [-1, 1] -> the 2048-d pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a = ConvBN(3, 32, (3, 3), stride=2)
        self.Conv2d_2a = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b = ConvBN(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b = ConvBN(64, 80, (1, 1))
        self.Conv2d_4a = ConvBN(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv2d_2b(self.Conv2d_2a(self.Conv2d_1a(x.permute(0, 3, 1, 2).to(torch.float32))))
        h = F.max_pool2d(h, 3, 2)
        h = F.max_pool2d(self.Conv2d_4a(self.Conv2d_3b(h)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))


def inception_preprocess(images01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> 299^2 in [-1, 1] (bilinear, antialiased as JAX's resize)."""
    return resize_bilinear(images01.to(torch.float32), 299, 299) * 2.0 - 1.0


def activation_statistics(feats: np.ndarray):
    """(N, 2048) -> (mu, sigma)."""
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Frechet distance between two Gaussians; sqrtm(C1 C2)'s trace from
    the eigenvalues of the symmetrised C1^1/2 C2 C1^1/2 (exact for SPD
    matrices, no scipy). Clamped at 0 (the eps regulariser can push an exact
    zero slightly negative)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    w1, v1 = np.linalg.eigh(sigma1 + eps * np.eye(sigma1.shape[0]))
    s1_half = (v1 * np.sqrt(np.maximum(w1, 0))) @ v1.T
    inner = s1_half @ sigma2 @ s1_half
    w, _ = np.linalg.eigh((inner + inner.T) / 2)
    tr_covmean = np.sum(np.sqrt(np.maximum(w, 0)))
    d = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)
    return max(d, 0.0)


def inception_features(params, images01, batch: int = 32, device="cuda") -> np.ndarray:
    """[0, 1] images (N, H, W, 3) -> (N, 2048) pool3 features, float64 numpy."""
    net = eval_net(InceptionV3Pool3, params, device)
    return extract(lambda x: net(inception_preprocess(x)), images01, batch, net)


def compute_fid(params, images_a01, images_b01, batch: int = 32, device="cuda") -> float:
    """FID between two [0, 1] image sets; ``params`` an ``InceptionV3Pool3``
    state dict (or the module)."""
    mu1, s1 = activation_statistics(inception_features(params, images_a01, batch, device))
    mu2, s2 = activation_statistics(inception_features(params, images_b01, batch, device))
    return frechet_distance(mu1, s1, mu2, s2)
