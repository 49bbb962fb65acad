"""The analytic counters of benchmark/flops.py against torch's FlopCounterMode
over the reference's modules on meta tensors, at the cells' sizes."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference.config import model_config
from benchmark.reference.unet import UNetModel
from benchmark.reference.vae import AutoencoderKL
from _tiny import REPO

CFG = json.loads((REPO / "benchmark/configs/sd1-inpaint-512.json").read_text())


def _count(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def nets():
    mc = model_config(CFG)
    with torch.device("meta"):
        return UNetModel(mc.unet), AutoencoderKL(mc.vae)


@pytest.mark.parametrize("latent,batch", [(64, 12), (128, 4)])
def test_unet_eval(nets, latent, batch):
    x = torch.empty(batch, latent, latent, 9, device="meta")
    t = torch.zeros(batch, dtype=torch.int64, device="meta")
    ctx = torch.empty(batch, 1, CFG["unet"]["context_dim"], device="meta")
    assert _count(nets[0], x, t, ctx) == flops.unet_eval(CFG["unet"], batch, latent, latent)


@pytest.mark.parametrize("height,width", [(512, 512), (1024, 1024), (720, 1280)])
def test_vae(nets, height, width):
    vae = nets[1]
    assert _count(vae.encode, torch.empty(2, height, width, 3, device="meta")) == \
        flops.vae_encode(CFG["vae"], 2, height, width)
    assert _count(vae.decode, torch.empty(2, height // 8, width // 8, 4, device="meta")) == \
        flops.vae_decode(CFG["vae"], 2, height // 8, width // 8)


def test_attention_and_feed_forward_sites(nets):
    """The per-site counters the roofline metrics use, against one site's modules."""
    block = nets[0].in_0_0_attn.block_0
    x = torch.empty(3, 4096, 320, device="meta")
    assert _count(block.attn1, x) == flops.attn1_work(3, 4096, 320)[0]
    assert _count(block.ff, x) == flops.ff_work(3 * 4096, 320, 1280)[0]


def test_least_seconds_takes_the_longer_bound():
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
