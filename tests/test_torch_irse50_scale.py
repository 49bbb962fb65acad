"""Why the card's eval gate seeds IR-SE-50 at LeCun scale: at He scale the
seeded net amplifies fp32 round-off on the CPU alone.

The port's ``IRSE50`` (full IR-SE-50, 112^2 input) seeded as
``chip_smoke.py::_seeded_eval`` seeds it (conv and dense kernels N(0, gain /
fan_in), perturbed frozen-BN statistics; torch generator 60) embeds four
``render_face`` faces (256^2, ``arcface_preprocess``). At LeCun scale (gain 1)
the embedding moves ~1e-6 of its peak when the input moves by +-1e-7 and sits
~1e-6 from a float64 forward (1.2e-6, 1.1e-6). At He scale (gain 2) the
activations grow ~10^4-fold through the 24 residual blocks, and the same
+-1e-7 moves the embedding by 2.4e-2 of its peak, as far as fp32 itself is
from float64 (2.6e-2): the 1.85e-1 between the card and the CPU at He scale
is that amplification of round-off (cuDNN's convolutions round otherwise than
the CPU's), not a card fault; at LeCun scale the card is within 2.3e-6.

``PYTHONPATH=. python tests/test_torch_irse50_scale.py`` prints both scales' figures.
"""

import copy
import math

import numpy as np
import pytest
import torch

from vface_torch.models.arcface import IRSE50, SEModule, _FrozenBNParams, arcface_preprocess
from vface_torch.models.layers import Conv, Dense
from vface_torch.preprocess.synthetic_faces import render_face


def seeded_irse50(gain: float, seed: int = 60) -> IRSE50:
    """``chip_smoke.py::_seeded_eval``'s seeding on the CPU."""
    g = torch.Generator().manual_seed(seed)
    net = IRSE50()
    with torch.no_grad():
        for mod in net.modules():
            rn = lambda t: torch.randn(t.shape, generator=g)
            if isinstance(mod, (Conv, Dense)):
                mod.weight.copy_(rn(mod.weight) * math.sqrt(gain / math.prod(mod.weight.shape[1:])))
                if mod.bias is not None:
                    mod.bias.copy_(rn(mod.bias) * 0.02)
            elif isinstance(mod, _FrozenBNParams):
                mod.weight.copy_(1.0 + 0.05 * rn(mod.weight))
                mod.bias.copy_(0.05 * rn(mod.bias))
                mod.mean.copy_(0.05 * rn(mod.mean))
                mod.var.copy_(0.5 + torch.rand(mod.var.shape, generator=g))
    return net.eval()


def faces(n: int = 4) -> torch.Tensor:
    rng = np.random.default_rng(70)
    return torch.from_numpy(np.stack([np.clip(render_face(rng, 256)[0], 0, 1) for _ in range(n)]).astype(np.float32))


def embed(net, x) -> np.ndarray:
    with torch.inference_mode():
        e = net(arcface_preprocess(x))
        return (e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)).double().numpy()


def embed_f64(net, x) -> np.ndarray:
    """The same forward in float64: the modules' float32 casts lifted."""
    n64 = copy.deepcopy(net).double()
    for m in n64.modules():
        if isinstance(m, (Conv, Dense)):
            m.dtype = torch.float64
    saved = _FrozenBNParams._apply_last, SEModule.forward
    _FrozenBNParams._apply_last = lambda self, v: (v - self.mean) * torch.rsqrt(self.var + self.eps) * self.weight + self.bias
    SEModule.forward = lambda self, v: v * torch.sigmoid(self.fc2(torch.relu(self.fc1(v.mean(dim=(2, 3), keepdim=True)))))
    try:
        return embed(n64, x.double())
    finally:
        _FrozenBNParams._apply_last, SEModule.forward = saved


def figures(gain: float, x) -> dict:
    net = seeded_irse50(gain)
    e32 = embed(net, x)
    rel = lambda a: float(np.abs(a - e32).max() / np.abs(e32).max())
    r = torch.from_numpy(np.random.default_rng(0).choice([-1.0, 1.0], size=x.shape).astype(np.float32))
    return {"input_1e-7": rel(embed(net, x + 1e-7 * r)), "fp64": rel(embed_f64(net, x))}


@pytest.fixture(scope="module")
def x():
    return faces()


def test_lecun_scale_is_well_conditioned(x):
    f = figures(1.0, x)
    assert f["input_1e-7"] < 1e-5 and f["fp64"] < 1e-5, f


def test_he_scale_amplifies_fp32_round_off(x):
    f = figures(2.0, x)
    assert f["input_1e-7"] > 1e-2 and f["fp64"] > 1e-2, f


if __name__ == "__main__":
    xs = faces()
    for gain in (1.0, 2.0):
        print(f"gain {gain}: " + ", ".join(f"{k} {v:.3e}" for k, v in figures(gain, xs).items()))
