"""Image cells: ``swap_image_batch`` on fresh seeded pairs a call.

Traffic keys: ``pairs`` (a call's batch; the UNet runs 2 x pairs rows under
CFG), ``ddim_steps``, ``cfg_scale``, ``warmup_steps``; ``check``: the limit of
each compared number. The start noise x_T is drawn with the pairs and handed
to the program as its noise source.

The check recomputes one pair of one call, both drawn from the seed, with the
reference (each pair's rows are computed apart from the other's, so one pair
alone gives what the batch gives it).
"""

from __future__ import annotations

import random

import torch

from benchmark import flops, generate, harness


class Cell:
    rate_metric = "pairs_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.latent = config["image_size"] // 2 ** (len(config["vae"]["ch_mult"]) - 1)

    def build(self) -> None:
        state, _ = harness.seeded_weights(self.config, self.seed, self.device)
        self.model = harness.program_model(self.config, state, self.device)
        del state

    def _run(self, inputs: dict, steps: int, timings):
        from vface_torch.pipelines.image_swap import ImageSwapOptions, swap_image_batch

        opts = ImageSwapOptions(ddim_steps=steps, cfg_scale=self.traffic["cfg_scale"],
                                image_size=self.config["image_size"])
        return swap_image_batch(self.model, inputs["target"], inputs["keep"], inputs["src_clip"], inputs["src01"],
                                inputs["landmarks"], opts, noise=lambda step, shape: inputs["x_T"], timings=timings)

    def warm_up(self) -> None:
        """One call at the cell's shapes, with fewer steps."""
        self._run(self.inputs(-1), self.traffic["warmup_steps"], None)

    def inputs(self, index: int) -> dict:
        return generate.image_pairs(self.traffic, generate.call_seed(self.seed, index), self.config["image_size"],
                                    self.latent, self.config["cond"]["clip"]["image_size"], self.device)

    def call(self, inputs: dict, timings):
        return self._run(inputs, self.traffic["ddim_steps"], timings)

    def keep(self, out):
        return out.cpu()

    def units(self, inputs: dict) -> int:
        return inputs["target"].shape[0]

    def network(self):
        """The program's model (``unet``, ``vae``, the conditioner)."""
        return self.model

    def flops_per_call(self) -> float:
        """50 CFG evals at 2 x pairs rows, the inpaint image's encode and the decode."""
        t, c, b = self.traffic, self.config, self.traffic["pairs"]
        s = c["image_size"]
        return (t["ddim_steps"] * flops.unet_eval(c["unet"], 2 * b, self.latent, self.latent)
                + flops.vae_encode(c["vae"], b, s, s) + flops.vae_decode(c["vae"], b, self.latent, self.latent))

    def release(self) -> None:
        del self.model

    def check(self, kept: list, seed: int, control=None) -> dict:
        """The compared numbers of one pair of one call, both drawn from the seed.
        ``control`` (a context manager over the reference's model) puts the
        reference under it in the program's place: its output is judged
        instead of the kept one, on the inputs a run with ``len(kept)`` calls
        checks."""
        from benchmark.reference.pipelines import swap_image_batch

        t = self.traffic
        rng = random.Random(seed)
        index, pair = rng.randrange(len(kept)), rng.randrange(t["pairs"])
        state, _ = harness.seeded_weights(self.config, self.seed, self.device)
        model = harness.reference_model(self.config, state, self.device)
        del state
        x = {k: v[pair:pair + 1] for k, v in self.inputs(index).items()}
        run = lambda: swap_image_batch(model, x["target"], x["keep"], x["src_clip"], x["src01"], x["landmarks"],
                                       x["x_T"], t["ddim_steps"], t["cfg_scale"])
        want = run()
        if control is None:
            got = kept[index][pair:pair + 1]
        else:
            with control(model):
                got = run()
        return {"pair_rel_l2": {"value": harness.rel_l2(got.cpu(), want.cpu()), "limit": t["check"]["pair_rel_l2"]}}
