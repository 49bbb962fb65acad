"""Video cells: ``VideoSwapPipeline.swap_video_frames`` on a fresh seeded clip a call.

Traffic keys: ``frames``, ``height``, ``width``, ``drift_px`` (the clip);
``window``, ``ddim_steps``, ``inversion_steps``, ``cfg_scale``, ``raft_iters``,
``parser_size`` (the operating point); ``warmup_steps`` (the warm-up call's
steps at the same shapes); ``check``: the limit of each compared number.

The check recomputes one window of one call, both drawn from the seed, with
the reference from the clip alone, and compares the pasted frames.
"""

from __future__ import annotations

import dataclasses
import random

import torch

from benchmark import flops, generate, harness


class Cell:
    rate_metric = "frames_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.latent = config["image_size"] // 2 ** (len(config["vae"]["ch_mult"]) - 1)

    def _opts(self, steps=None):
        from vface_torch.pipelines.video_swap import SwapOptions

        t = self.traffic
        return SwapOptions(ddim_steps=steps or t["ddim_steps"], inversion_steps=steps or t["inversion_steps"],
                           cfg_scale=t["cfg_scale"], window=t["window"], image_size=self.config["image_size"],
                           parser_size=t["parser_size"], raft_iters=t["raft_iters"], flow_tokens=self.latent ** 2)

    def build(self) -> None:
        from vface_torch.pipelines.video_swap import VideoSwapPipeline

        state, self.aux = harness.seeded_weights(self.config, self.seed, self.device)
        model = harness.program_model(self.config, state, self.device)
        del state
        self.pipe = VideoSwapPipeline(model, self._opts(), device=self.device, aux_params=self.aux)

    def warm_up(self) -> None:
        """One call at the window's shapes, with fewer steps."""
        from vface_torch.pipelines.video_swap import VideoSwapPipeline

        short = VideoSwapPipeline(self.pipe.model, self._opts(self.traffic["warmup_steps"]), device=self.device,
                                  aux_params=self.aux)
        inputs = self.inputs(-1)
        short.swap_video_frames(inputs["frames"], inputs["source"])

    def inputs(self, index: int) -> dict:
        return generate.video_clip(self.traffic, generate.call_seed(self.seed, index), self.device)

    def call(self, inputs: dict, timings):
        return self.pipe.swap_video_frames(inputs["frames"], inputs["source"], timings=timings)

    def keep(self, out):
        return out.cpu()

    def units(self, inputs: dict) -> int:
        return inputs["frames"].shape[0]

    def network(self):
        """The program's model (``unet``, ``vae``, the conditioner)."""
        return self.pipe.model

    def flops_per_call(self) -> float:
        """The UNet's evals (inversion at F rows, recon-free CFG sampling at 2F) and
        the VAE's encodes and decodes (crops, inpaint crops, the frames' round trip)."""
        t, c = self.traffic, self.config
        s, hl = c["image_size"], self.latent
        h, w = t["height"], t["width"]
        total = 0.0
        for s0 in range(0, t["frames"], t["window"]):
            f = min(t["window"], t["frames"] - s0)
            total += (t["inversion_steps"] - 1) * flops.unet_eval(c["unet"], f, hl, hl)
            total += t["ddim_steps"] * flops.unet_eval(c["unet"], 2 * f, hl, hl)
            total += 2 * flops.vae_encode(c["vae"], f, s, s) + flops.vae_decode(c["vae"], f, hl, hl)
            total += flops.vae_encode(c["vae"], f, h, w) + flops.vae_decode(c["vae"], f, h * hl // s, w * hl // s)
        return total

    def release(self) -> None:
        del self.pipe

    def check(self, kept: list, seed: int, control=None) -> dict:
        """The compared numbers of one window of one call, both drawn from the
        seed. ``control`` (a context manager over the reference's model) puts
        the reference under it in the program's place: its output is judged
        instead of the kept one, on the inputs a run with ``len(kept)`` calls
        checks."""
        from benchmark.reference.pipelines import VideoOptions, VideoSwapReference

        t = self.traffic
        rng = random.Random(seed)
        index = rng.randrange(len(kept))
        start = rng.randrange(0, t["frames"], t["window"])
        state, aux = harness.seeded_weights(self.config, self.seed, self.device)
        model = harness.reference_model(self.config, state, self.device)
        del state
        opts = VideoOptions(**{f.name: t[f.name] for f in dataclasses.fields(VideoOptions) if f.name in t},
                            flow_tokens=self.latent ** 2)
        inputs = self.inputs(index)
        ref = VideoSwapReference(model, opts, aux)
        run = lambda: ref.swap_window_frames(inputs["frames"], inputs["source"], start)
        want = run()
        if control is None:
            got = kept[index][start:start + t["window"]]
        else:
            with control(model):
                got = run()
        return {"window_rel_l2": {"value": harness.rel_l2(got.cpu(), want.cpu()),
                                  "limit": t["check"]["window_rel_l2"]}}
