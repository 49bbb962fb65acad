"""The cross-window FGATS carry in the port: the UNet's carry out of its flow
sites, the sequential window loop that threads it, and the CLI flag.

Tiny bundle (``ModelConfig.tiny(image_size=32)``, conditioner included, from
seeded numpy: no JAX init is compiled), fp32 on the CPU, ``SwapOptions(
ddim_steps=2, inversion_steps=2, window=3, image_size=32, parser_size=64,
raft_iters=2, flow_tokens=256)``, so that FGATS, and with it the carry,
engages at the tiny latent's 16^2 tokens. The clip: 6 frames of 48 x 64 at
window 3 (two windows, as ``tests/test_pipeline_e2e.py::
test_cross_window_fgats_carry``), with precomputed keep-masks.

Limits: ``apply_model``'s epsilon and carry within 1e-5 (fp32 round-off
through one UNet eval); the carried loop within 1e-4 of JAX's (as the loop
without the carry, ``test_torch_video.py``).
"""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port import close, np_tree, t, tiny_video_bundle
from vface_torch.models.unet import InjectionSpec
from vface_torch.ops.attention import FlowPack, FusionConfig
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

S, H, W, N = 32, 48, 64, 6
OPTS = dict(ddim_steps=2, inversion_steps=2, window=3, image_size=S, parser_size=64, raft_iters=2, flow_tokens=256)
F, HL, C, D = 3, 16, 32, 64  # frames, latent side, ds1 channels, context width of the tiny UNet


@pytest.fixture(scope="module")
def bundle():
    return tiny_video_bundle(N, seed=81, s=S, hw=(H, W))


def _swap(bundle, pipe):
    return pipe.swap_video_frames(bundle["frames"], bundle["source"], frame_keep=bundle["keep"],
                                  source_keep=bundle["keep"][0])


@pytest.fixture(scope="module")
def runs(bundle):
    """The port's loop with the carry on and off."""
    pipe = lambda **f: VideoSwapPipeline(bundle["model"], SwapOptions(**{**OPTS, **f}), device="cpu",
                                         aux_params=bundle["aux"])
    return {"on": _swap(bundle, pipe(cross_window_carry=True)), "off": _swap(bundle, pipe())}


def test_apply_model_carry_matches_jax(bundle):
    """One recon-free sampling eval (2 chunks of 3 frames, FSAI + FGATS) fed a
    previous window's carry and a boundary flow: epsilon, and the carry dict's
    keys (the Flax site paths) and values, within 1e-5 of JAX's."""
    import jax.numpy as jnp

    from vface_tpu.models.unet import InjectionSpec as JInjectionSpec
    from vface_tpu.ops.attention import FlowPack as JFlowPack
    from vface_tpu.ops.attention import FusionConfig as JFusionConfig

    r = np.random.default_rng(90)
    n = lambda *shape, scale=1.0: (r.normal(size=shape) * scale).astype(np.float32)
    x9, ctx, flow, flow0 = n(2 * F, HL, HL, 9), n(2 * F, 1, D), n(F - 1, HL, HL, 2, scale=1.5), n(1, HL, HL, 2)
    prev = {"in_0_0_attn": {"q": n(1, HL * HL, C), "k": n(1, HL * HL, C)}}
    ts = np.full((2 * F,), 500, np.int32)
    jinj = JInjectionSpec(input_blocks=JFusionConfig("flow_fix", flow_tokens=HL * HL, two_chunk_replace=False),
                          chunks=2)
    jpack = JFlowPack(flow=jnp.asarray(flow), prev=prev, flow0=jnp.asarray(flow0))
    want_eps, want = np_tree(bundle["jm"].apply_model(bundle["params"], x9, ts, ctx, flow=jpack, injection=jinj,
                                                      return_fgats_carry=True))
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=HL * HL, two_chunk_replace=False),
                        chunks=2)
    pack = FlowPack(flow=t(flow), prev={s: {k: t(v) for k, v in qk.items()} for s, qk in prev.items()},
                    flow0=t(flow0))
    with torch.inference_mode():
        eps, got = bundle["model"].apply_model(t(x9), t(ts).long(), t(ctx), flow=pack, injection=inj,
                                               return_fgats_carry=True)
    close(eps, want_eps, atol=1e-5)
    assert sorted(got) == sorted(want) == ["in_0_0_attn"]
    for site, qk in want.items():
        assert sorted(got[site]) == sorted(qk) == ["k", "q"]
        for k, v in qk.items():
            assert tuple(got[site][k].shape) == v.shape == (1, HL * HL, C)
            close(got[site][k], v, atol=1e-5)


def test_carried_loop_matches_jax(bundle, runs):
    """``cross_window_carry=True`` on two windows: within 1e-4 of JAX's loop."""
    from vface_tpu.pipelines.video_swap import SwapOptions as JSwapOptions
    from vface_tpu.pipelines.video_swap import VideoSwapPipeline as JPipeline

    jpipe = JPipeline(bundle["jm"], JSwapOptions(**OPTS, cross_window_carry=True))
    want = jpipe.swap_video_frames(bundle["params"], bundle["jaux"], bundle["frames"], bundle["source"],
                                   frame_keep=bundle["keep"], source_keep=bundle["keep"][0])
    close(runs["on"], np.asarray(want), atol=1e-4)


def test_carry_changes_only_the_later_windows(runs):
    """Window 0 has no predecessor and equals the carry-off run exactly;
    window 1's frame 0 blends with window 0's last frame, so it differs."""
    np.testing.assert_array_equal(runs["on"][:3].numpy(), runs["off"][:3].numpy())
    assert float((runs["on"][3:] - runs["off"][3:]).abs().max()) > 1e-6


def test_cli_cross_window_carry(bundle, tmp_path, monkeypatch):
    """``--cross_window_carry --tiny`` runs the carried loop, and the CLI's frames
    equal the pipeline's on the same seeded weights and inputs."""
    from vface_torch.io.image import read_png, write_png
    from vface_torch.io.video import write_y4m
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.scripts import vface_video_swap as cli
    from vface_torch.utils.convert import init_aux_params, init_params

    clip = (bundle["frames"] * 255).astype(np.uint8)
    write_y4m(str(tmp_path / "v.y4m"), clip, fps=10)
    write_png(str(tmp_path / "src.png"), (bundle["source"] * 255).astype(np.uint8))
    (tmp_path / "pairs.yaml").write_text(f"- video: {tmp_path / 'v.y4m'}\n  source: {tmp_path / 'src.png'}\n")
    monkeypatch.setenv("VFACE_PLATFORM", "cpu")
    seen = []
    real = VideoSwapPipeline.swap_video_frames

    def spy(self, *args, **kw):
        seen.append(self.opts.cross_window_carry)
        return real(self, *args, **kw)

    with mock.patch.object(VideoSwapPipeline, "swap_video_frames", spy):
        rc = cli.main(["--config", str(tmp_path / "pairs.yaml"), "--outdir", str(tmp_path / "out"), "--tiny",
                       "--n_frames", "3", "--ddim_steps", "2", "--inversion_steps", "2", "--seed", "5",
                       "--cross_window_carry"])
    assert rc == 0 and seen == [True]

    cfg = ModelConfig.tiny(image_size=S)
    model = VFaceModel(cfg, device="cpu", conditioner=True)
    model.load_params(init_params(cfg, torch.Generator().manual_seed(5), conditioner=True))
    opts = SwapOptions(ddim_steps=2, inversion_steps=2, window=3, image_size=S, parser_size=64,
                       cross_window_carry=True)
    pipe = VideoSwapPipeline(model, opts, device="cpu", aux_params=init_aux_params(torch.Generator().manual_seed(6)))
    frames01, _ = cli.load_frames(str(tmp_path / "v.y4m"))
    want = pipe.swap_video_frames(frames01, read_png(str(tmp_path / "src.png"), mode="RGB").astype(np.float32) / 255.0)
    want = (np.clip(want.numpy(), 0, 1) * 255).astype(np.uint8)
    got = np.stack([read_png(str(Path(tmp_path / "out" / "v_frames" / f"{i}.png"))) for i in range(N)])
    np.testing.assert_array_equal(got, want)
