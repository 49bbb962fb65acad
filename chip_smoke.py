"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                      # every phase, as a CI smoke run
    python3 chip_smoke.py --profile out.txt    # and a profile of one UNet eval
    python3 chip_smoke.py --profile-train out.txt  # and a profile of one train step

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA C++ kernel of the port, one nvcc each, in parallel,
     plus the Triton kernel's compile on its first launch;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, with the stated tolerance, its time, the plain version's time,
     the time of one PyTorch library call computing the same function (where
     one exists) and the card's bound: K1-K3 at the shapes the swap path
     gives them, K4-K6 (the training attention) at the training shapes;
  4. swap: ``VideoSwapPipeline.swap_window`` at the SD-v1 inpainting widths
     (512^2, latent 64^2, bf16) on a 6-frame window with a random flow and
     seeded random weights, 50 inversion and 50 sampling steps (after a
     2 + 2-step warm-up), with the wall time per stage and the kernels'
     launch counts over that run; the output is checked for shape, finite
     values and the [0, 1] range;
  5. reference: one full-width UNet eval and one VAE decode with the kernels
     and with their plain versions swapped in, relative L2 error; and the
     tiny fp32 config's swap_window on the card against the same call on the
     CPU (the one the tests hold to the JAX package);
  6. train: the REFace training step (``make_optimizer`` / ``make_train_step``)
     at full width, batch 1 at 512^2, the reference operating point (4-step
     DDIM reconstruction with the ArcFace ID loss, LPIPS off), CLIP ViT-L/14
     and IRSE50 in the conditioner: one warm-up step and 5 timed steps, ms per
     step, peak memory, the loss terms and the kernels' launches per step;
  7. train_reference: one full-width step's UNet gradients with the kernels
     and with their plain versions, relative L2 error, and every trainable
     group's gradient finite and non-zero; the tiny fp32 ``p_losses_face``
     and its gradients on the card against the CPU;
  8. (``--profile PATH``, ``--profile-train PATH``) CUDA time by kernel of one
     sampling UNet eval, of one train step;
  9. the card line, the ``kernels`` JSON line, then the result line.

TF32 is off for matmuls and convolutions throughout (the port's float32 ops,
the FSAI circulant and the warp, run in full float32).

Exits non-zero, printing no result, without CUDA or without the port.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FRAMES = 6  # frames per window at the reference operating point
DDIM_STEPS = 50  # sampling steps at the reference operating point
INVERSION_STEPS = 50  # inversion steps (49 run: skip_last=1)
SEED = 0  # weights and inputs


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from vface_torch.ops import _native

    t0 = time.perf_counter()
    logs = _native.build()
    log("build", sources=",".join(_native.SOURCES), seconds=f"{time.perf_counter() - t0:.1f}")
    for name, text in logs.items():  # ptxas: registers and spills of each instantiation
        regs = [line.split("Used")[1].split(",")[0].strip() for line in text.splitlines() if "Used" in line]
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1]) for line in text.splitlines()
                     if "spill stores" in line)
        log("ptxas", source=name, instantiations=len(regs), registers="/".join(r.split()[0] for r in regs),
            spill_store_bytes=spills)


def _row(name, route, source, replaces, errs, tol, ms, plain_ms, lib_ms, bnd, shape):
    """errs = (max abs error, max relative error); tol = ("abs" or "rel", limit)."""
    checked = errs[0] if tol[0] == "abs" else errs[1]
    log("kernel", name=name, shape=shape, max_abs_err=f"{errs[0]:.3e}", max_rel_err=f"{errs[1]:.3e}",
        tol=f"{tol[0]}<={tol[1]:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.4f}", bound_ms=f"{bnd[0]:.4f}",
        bound_by=bnd[1])
    if not checked <= tol[1]:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version: {checked} > {tol}")
    return {"name": name, "route": route, "source": source, "replaces": replaces, "shape": shape,
            "max_abs_err": errs[0], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib_ms}


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _errs(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / want.float().abs().max().item()


# K6 and K5 keep P and dS at fp32 precision (hi + lo bf16 products). The
# 2-ulp limit on the max error cannot tell that from rounding them to bf16
# alone, which moves it by about one ulp; relative L2 error can, since that
# rounding flips the output's rounding in a large share of the elements.
# Each output's relative L2 error against its fp32 plain version must stay
# under this share of the yardstick's: the same plain version with P and dS
# rounded to bf16 alone (1.0 for a kernel that rounds them so).
PRECISION_GATE = 0.25


def precision_gate(name: str, shape: str, got, want, yardstick) -> None:
    rel = lambda a: float((a.float() - want.float()).norm() / want.float().norm())
    ratio = rel(got) / rel(yardstick)
    log("kernel_precision", name=name, shape=shape, rel_l2=f"{rel(got):.3e}",
        bf16_p_rel_l2=f"{rel(yardstick):.3e}", ratio=f"{ratio:.3f}", limit=PRECISION_GATE)
    if not ratio <= PRECISION_GATE:
        raise SystemExit(f"chip_smoke: {name} is not at fp32 precision in P and dS: "
                         f"{ratio:.3f} of bf16 rounding's error > {PRECISION_GATE}")


def phase_kernels(batch: int, vae_batch: int) -> dict:
    """Each kernel against its plain version at the swap path's shapes; returns the rows.

    K1 and K2 at the sampling batch (2 chunks x the window), K3 at the VAE's
    (the window).
    """
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA
    from vface_torch.ops import geglu_ff as FF
    from vface_torch.ops import gn_sums as GN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    rows = {}

    # K1 at the two self-attention sites it serves: ds1 (dh 40) and ds2 (dh 80).
    # Both round the same fp32 values to bf16; sums in another order may flip
    # one rounding of P or of the output, so the limit is 2 bf16 ulps at the
    # output's peak (at ds1 ~2e-3; dropping one K/V tile errs by ~1e-1).
    fa_rows = []
    for n, c in ((4096, 320), (1024, 640)):
        h = 8
        dh = c // h
        q, k, v = randn(batch, n, c), randn(batch, n, c), randn(batch, n, c)
        got = FA.flash_attention(q, k, v, h)
        want = FA.flash_attention_ref(q, k, v, h)
        torch.cuda.synchronize()
        errs = _errs(got, want)
        tol = 2 * bf16_ulp(want.float().abs().max().item())
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, h))
        plain_ms = cuda_ms(lambda: FA.flash_attention_ref(q, k, v, h), reps=3, warmup=1)
        split = lambda t: t.view(batch, n, h, dh).transpose(1, 2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)))
        bnd = bound(4.0 * batch * h * n * n * dh, 4 * q.numel() * 2)
        fa_rows.append(_row("flash_attention", "cuda", "vface_torch/csrc/flash_attention.cu",
                            "vface_tpu/ops/pallas_attention.py:547", errs, ("abs", tol), ms, plain_ms,
                            lib_ms, bnd, f"({batch},{n},{c})h{h}"))
    rows["flash_attention"] = fa_rows

    # K2 at the ds1 and ds2 transformer feed-forwards
    ff_rows = []
    for n, c in ((4096, 320), (1024, 640)):
        inner = 4 * c
        x = randn(batch * n, c)
        wp, bp = randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1)
        wo, bo = randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1)
        got = FF.geglu_ff(x, wp, bp, wo, bo)
        want = FF.geglu_ff_ref(x, wp, bp, wo, bo)
        torch.cuda.synchronize()
        errs = _errs(got, want)
        ms = cuda_ms(lambda: FF.geglu_ff(x, wp, bp, wo, bo))
        plain_ms = cuda_ms(lambda: FF.geglu_ff_ref(x, wp, bp, wo, bo), reps=3, warmup=1)
        m = batch * n
        bnd = bound(6.0 * m * c * inner, (2 * m * c + 3 * c * inner + 2 * inner + c) * 2)
        ff_rows.append(_row("geglu_ff", "cuda", "vface_torch/csrc/geglu_ff.cu",
                            "vface_tpu/ops/pallas_ff.py:70", errs, ("abs", 3e-2), ms, plain_ms, None, bnd,
                            f"({m},{c})I{inner}"))
    rows["geglu_ff"] = ff_rows

    # K3 at the VAE's largest and smallest eligible GroupNorm sites
    gn_rows = []
    for c, s in ((128, 512), (512, 128)):
        x = randn(vae_batch, c, s, s)
        s1, s2 = GN.gn_sums(x)
        r1, r2 = GN.gn_sums_ref(x)
        torch.cuda.synchronize()
        # relative to each row's sum of |x| (s1 may be near 0) and to s2 itself
        absx = x.float().abs().sum(dim=(2, 3))
        errs = (max((s1 - r1).abs().max().item(), (s2 - r2).abs().max().item()),
                max(((s1 - r1).abs() / absx).max().item(), ((s2 - r2).abs() / r2).max().item()))
        ms = cuda_ms(lambda: GN.gn_sums(x))
        plain_ms = cuda_ms(lambda: GN.gn_sums_ref(x))
        lib_ms = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3)))
        bnd = bound(2.0 * x.numel(), x.numel() * 2 + 2 * vae_batch * c * 4, PEAK_FP32_FLOPS)
        gn_rows.append(_row("gn_sums", "triton", "vface_torch/ops/gn_sums.py",
                            "vface_tpu/models/layers.py:45", errs, ("rel", 1e-5), ms, plain_ms, lib_ms, bnd,
                            f"({vae_batch},{c},{s},{s})"))
    rows["gn_sums"] = gn_rows
    return rows


SWAP_KERNELS = ("flash_attention", "geglu_ff", "gn_sums")
TRAIN_KERNELS = ("flash_attention_stats", "flash_attention_fp32", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "geglu_ff", "gn_sums")


def kernel_counts() -> dict:
    """Every kernel's launches since the last reset, by name."""
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    return {**FA.LAUNCHES, "geglu_ff": FF.LAUNCHES, "gn_sums": GN.LAUNCHES}


def reset_counts() -> None:
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    for name in FA.LAUNCHES:
        FA.LAUNCHES[name] = 0
    FF.LAUNCHES = 0
    GN.LAUNCHES = 0


@contextlib.contextmanager
def plain_kernels():
    """Route the models' three kernel call sites to the plain versions: the
    attention's forward and backward (K1, or K4 with K6 and K5), GEGLU's
    forward (its backward is plain already) and the GroupNorm sums."""
    from unittest import mock

    from vface_torch.models import layers, unet
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    with mock.patch.object(unet, "flash_attention", FA.flash_attention_ref), \
            mock.patch.object(unet, "geglu_ff", FF.geglu_ff_ref), \
            mock.patch.object(layers, "gn_sums", GN.gn_sums_ref):
        yield


def build_model(seed: int, conditioner: bool = False):
    """The full-width model with seeded weights; the conditioner only for training."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig.sd_v1_inpaint()
    t0 = time.perf_counter()
    model = VFaceModel(cfg, device="cuda", conditioner=conditioner)
    model.load_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), conditioner=conditioner))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("model", config="sd_v1_inpaint", dtype="bfloat16", conditioner=conditioner, params=n_params,
        init_seconds=f"{time.perf_counter() - t0:.1f}")
    return model


def window_inputs(model, frames: int, seed: int):
    """Seeded crops, keep-mask, conditioning and flow for one window at 512^2."""
    import torch

    s = model.cfg.image_size
    d = model.cfg.unet.context_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    yy, xx = torch.meshgrid(torch.arange(s, device="cuda"), torch.arange(s, device="cuda"), indexing="ij")
    face = (((yy - s * 0.55) / (s * 0.30)) ** 2 + ((xx - s * 0.5) / (s * 0.24)) ** 2) <= 1.0
    keep = (~face).to(torch.float32)[None, :, :, None]
    # smooth random images in [-1, 1]: low-frequency noise upsampled
    base = torch.nn.functional.interpolate(r(frames + 1, 3, s // 32, s // 32), size=(s, s), mode="bilinear")
    imgs = torch.tanh(base).permute(0, 2, 3, 1)
    return dict(
        crops=imgs[:frames].contiguous(), keep_mask=keep.expand(frames, s, s, 1).contiguous(),
        cond=r(frames, 1, d), uncond=r(frames, 1, d), inverse_cond=r(frames, 1, d),
        cond_w_src=r(frames, 1, d), src_crop=imgs[frames:].contiguous(), src_keep_mask=keep,
        flow=3.0 * torch.nn.functional.interpolate(r(frames - 1, 2, 16, 16), size=(s, s),
                                                   mode="bilinear").permute(0, 2, 3, 1).contiguous(),
    )


def phase_swap(model, frames: int, steps: int, inv_steps: int, seed: int) -> dict:
    """The main path: swap_window at full width; returns the kernels' launch counts."""
    import torch

    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

    opts = SwapOptions(ddim_steps=steps, inversion_steps=inv_steps, window=frames,
                       image_size=model.cfg.image_size)
    pipe = VideoSwapPipeline(model, opts, device="cuda")
    inputs = window_inputs(model, frames, seed)
    # warm-up at 2 + 2 steps: cuDNN's algorithm choice and lazy CUDA module
    # loads land here, not in the measured drive below
    t0 = time.perf_counter()
    short = SwapOptions(ddim_steps=2, inversion_steps=2, window=frames, image_size=model.cfg.image_size)
    VideoSwapPipeline(model, short, device="cuda").swap_window(**inputs)
    torch.cuda.synchronize()
    log("warmup", ddim_steps=2, inversion_steps=2, wall_s=f"{time.perf_counter() - t0:.3f}")
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    out = pipe.swap_window(**inputs, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    n_inv = inv_steps - 1  # skip_last=1 at the recon-free operating point
    unet_evals = n_inv + steps
    log("swap", frames=frames, ddim_steps=steps, inversion_steps=inv_steps, inversion_evals=n_inv,
        image=f"{opts.image_size}^2", wall_s=f"{wall:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in timings.items()},
        sample_ms_per_eval=f"{timings['sample'] / steps * 1e3:.1f}",
        invert_ms_per_eval=f"{timings['invert'] / max(n_inv, 1) * 1e3:.1f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    log("launches", **launches, unet_evals=unet_evals,
        per_unet_eval=",".join(f"{k}:{launches[k] / unet_evals:g}" for k in SWAP_KERNELS if k != "gn_sums"),
        gn_sums_per_vae_pass=f"{launches['gn_sums'] / 3:g}")
    ok = (tuple(out.shape) == (frames, opts.image_size, opts.image_size, 3)
          and bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0)
    log("swap_check", shape=tuple(out.shape), dtype=out.dtype, finite=bool(torch.isfinite(out).all()),
        min=f"{float(out.min()):.4f}", max=f"{float(out.max()):.4f}", std=f"{float(out.float().std()):.4f}")
    if not ok:
        raise SystemExit("chip_smoke: swap output has the wrong shape, is not finite or leaves [0, 1]")
    missing = [k for k in SWAP_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the swap path launched no {missing} kernel")
    stray = [k for k in launches if k not in SWAP_KERNELS and launches[k]]
    if stray:  # serving runs without gradients: the training kernels must not run
        raise SystemExit(f"chip_smoke: the swap path launched training kernels {stray}")
    return launches


def phase_reference(model, frames: int, seed: int) -> None:
    """Full-width UNet eval (2-chunk sampling batch, FSAI + FGATS) and VAE decode on
    the card, with the kernels and with their plain versions; relative L2 error."""
    import torch

    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops.attention import FusionConfig
    from vface_torch.ops.warp import resize_flow

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    hl, d = model.cfg.latent_size, model.cfg.unet.context_dim
    x9 = torch.randn((2 * frames, hl, hl, 9), generator=g, device="cuda")
    ts = torch.full((2 * frames,), 961, device="cuda")
    ctx = torch.randn((2 * frames, 1, d), generator=g, device="cuda")
    flow = resize_flow(window_inputs(model, frames, seed)["flow"], hl, hl)
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", two_chunk_replace=False), chunks=2)
    z = torch.randn((frames, hl, hl, 4), generator=g, device="cuda")
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    with torch.inference_mode():
        eps_k = model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
        img_k = model.decode_first_stage(z)
        with plain_kernels():
            eps_p = model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
            img_p = model.decode_first_stage(z)
    torch.cuda.synchronize()
    e_eps, e_img = rel(eps_k, eps_p), rel(img_k, img_p)
    # the plain versions share the kernels' rounding points; fp32 sums in
    # another order move a bf16 rounding by an ulp (2^-8) here and there, and
    # ~70 bf16 layers with random weights carry that to ~1e-2 of the output
    tol = 3e-2
    log("reference", unet_eps_rel_l2=f"{e_eps:.3e}", vae_decode_rel_l2=f"{e_img:.3e}", tol=tol,
        note="bf16 kernels vs plain versions, full width")
    if not (e_eps <= tol and e_img <= tol):
        raise SystemExit("chip_smoke: the kernel path disagrees with the plain path at full width")


def phase_profile(model, frames: int, seed: int, path: str) -> None:
    """CUDA time by kernel for one 2-chunk sampling UNet eval at full width
    (torch.profiler); the top rows are printed, the whole table goes to ``path``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops.attention import FusionConfig
    from vface_torch.ops.warp import resize_flow

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    hl, d = model.cfg.latent_size, model.cfg.unet.context_dim
    x9 = torch.randn((2 * frames, hl, hl, 9), generator=g, device="cuda")
    ts = torch.full((2 * frames,), 961, device="cuda")
    ctx = torch.randn((2 * frames, 1, d), generator=g, device="cuda")
    flow = resize_flow(window_inputs(model, frames, seed)["flow"], hl, hl)
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", two_chunk_replace=False), chunks=2)
    run = lambda: model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(table)
    log("profile", batch=2 * frames, wall_ms=f"{wall_ms:.1f}", device_ms=f"{total:.1f}",
        device_busy=f"{total / wall_ms:.3f}", table=path)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


def phase_small_reference(seed: int) -> None:
    """The tiny fp32 config's swap_window (FSAI + FGATS engaged) on the card
    against the same call on the CPU, which tests/test_torch_swap.py holds to
    the JAX package; same seeded weights and inputs."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig.tiny(image_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    opts = SwapOptions(ddim_steps=4, inversion_steps=4, window=3, image_size=32, flow_tokens=256)
    g = torch.Generator().manual_seed(seed + 3)
    keep = torch.ones(3, 32, 32, 1)
    keep[:, 8:26, 6:24] = 0.0
    inputs = dict(crops=torch.rand(3, 32, 32, 3, generator=g) * 2 - 1, keep_mask=keep,
                  cond=torch.randn(3, 1, 64, generator=g), uncond=torch.randn(3, 1, 64, generator=g),
                  inverse_cond=torch.randn(3, 1, 64, generator=g),
                  cond_w_src=torch.randn(3, 1, 64, generator=g),
                  src_crop=torch.rand(1, 32, 32, 3, generator=g) * 2 - 1, src_keep_mask=keep[:1],
                  flow=torch.randn(2, 32, 32, 2, generator=g) * 2)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = VFaceModel(cfg, device=dev)
        model.load_params(params)
        outs[dev] = VideoSwapPipeline(model, opts, device=dev).swap_window(**inputs).cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    tol = 1e-4  # fp32 throughout, TF32 off: summation order only
    log("small_reference", config="tiny fp32 32^2, 3 frames, 4 + 4 steps", max_abs_err=f"{err:.3e}",
        tol=tol)
    if not err <= tol:
        raise SystemExit("chip_smoke: the card's tiny swap disagrees with the CPU's")


def phase_train_kernels() -> dict:
    """K4, K6 and K5 against their plain versions at the training shapes, batch 1:
    ds1 (1, 4096, 320) and ds2 (1, 1024, 640), 8 heads, bf16. Limit: 2 bf16 ulps
    at the peak of each output (K4 also checks m and l to 1e-5 relative); K6
    and K5 also pass :func:`precision_gate`.

    Bound: the function's least FLOPs (2 N^2-products for K4 and K6, 5 for K5:
    S, dP, dQ, dK, dV) at the bf16 tensor-core peak, which all three use (K6
    and K5 run their fp32-valued P and dS as two bf16 products each, hi + lo:
    the bound counts the function's products once), or its bytes. Library:
    one SDPA forward (K4), the autograd backward of SDPA's output (K5), SDPA
    on fp32 inputs (K6)."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    rows = {"flash_attention_stats": [], "flash_attention_bwd": [], "flash_attention_fp32": []}
    src = "vface_torch/csrc/flash_attention_bwd.cu"
    for n, c in ((4096, 320), (1024, 640)):
        h, b = 8, 1
        dh = c // h
        q, k, v, do = randn(b, n, c), randn(b, n, c), randn(b, n, c), randn(b, n, c)
        shape = f"({b},{n},{c})h{h}"
        split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
        n2dh = float(b * h * n * n * dh)
        act = q.numel() * 2  # bytes of one (B, N, C) bf16 tensor
        stat = b * h * n * 4  # bytes of one fp32 (B*H, N) statistic

        out, m, l = FA.flash_attention_stats(q, k, v, h)
        want, wm, wl = FA.flash_attention_stats_ref(q, k, v, h)
        torch.cuda.synchronize()
        rel_ml = max(((m - wm).abs() / wm.abs().clamp(min=1e-30)).max().item(),
                     ((l - wl).abs() / wl).max().item())
        if not rel_ml <= 1e-5:
            raise SystemExit(f"chip_smoke: flash_attention_stats m/l disagree: {rel_ml} > 1e-5")
        if not torch.equal(out, FA.flash_attention(q, k, v, h)):
            raise SystemExit("chip_smoke: flash_attention_stats's output is not K1's bit for bit")
        rows["flash_attention_stats"].append(_row(
            "flash_attention_stats", "cuda", "vface_torch/csrc/flash_attention.cu",
            "vface_tpu/ops/pallas_attention.py:658", _errs(out, want),
            ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_stats(q, k, v, h)),
            cuda_ms(lambda: FA.flash_attention_stats_ref(q, k, v, h), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))),
            bound(4.0 * n2dh, 4 * act + 2 * stat), shape))
        log("kernel_stats_check", shape=shape, m_l_max_rel_err=f"{rel_ml:.3e}", tol="1e-05",
            equals_k1="bitwise")

        o6 = FA.flash_attention_fp32(q, k, v, h)
        want6 = FA.flash_attention_fp32_ref(q, k, v, h)
        torch.cuda.synchronize()
        # the yardstick: K4's plain version, which rounds P to bf16 alone
        precision_gate("flash_attention_fp32", shape, o6, want6, want)
        qf, kf, vf = (split(t).float() for t in (q, k, v))
        rows["flash_attention_fp32"].append(_row(
            "flash_attention_fp32", "cuda", src, "vface_tpu/ops/pallas_attention.py:143", _errs(o6, want6),
            ("abs", 2 * bf16_ulp(want6.float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_fp32(q, k, v, h)),
            cuda_ms(lambda: FA.flash_attention_fp32_ref(q, k, v, h), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf)),
            bound(4.0 * n2dh, 4 * act), shape))

        dd = FA.rowsum_do_o(do, o6, h)
        got = FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)
        want5 = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h)
        torch.cuda.synchronize()
        # each gradient against 2 ulps of its own peak; the row reports the worst margin
        ratios = [_errs(gi, wi)[0] / (2 * bf16_ulp(wi.float().abs().max().item())) for gi, wi in zip(got, want5)]
        worst = max(range(3), key=lambda i: ratios[i])
        errs = _errs(got[worst], want5[worst])
        log("kernel_bwd_check", shape=shape, dq_dk_dv_err_over_tol=",".join(f"{r:.3f}" for r in ratios))
        yard = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h, round_p=True)
        for gname, gi, wi, yi in zip(("dq", "dk", "dv"), got, want5, yard):
            precision_gate(f"flash_attention_bwd.{gname}", shape, gi, wi, yi)
        leaves = [split(t).detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        dsplit = split(do)
        rows["flash_attention_bwd"].append(_row(
            "flash_attention_bwd", "cuda", src, "vface_tpu/ops/pallas_attention.py:444", errs,
            ("abs", 2 * bf16_ulp(want5[worst].float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)),
            cuda_ms(lambda: FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h), reps=3, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dsplit, retain_graph=True)),
            bound(10.0 * n2dh, 7 * act + 3 * stat), shape))
    return rows


def train_batch(model, batch: int, seed: int, device="cuda") -> dict:
    """A seeded synthetic batch shaped as the JAX package's train-step bench:
    images and mask at the model's size, the 224^2 CLIP reference, the 112^2
    ArcFace reference and 136 landmark coordinates."""
    import torch

    s, clip = model.cfg.image_size, model.cfg.cond.clip.image_size
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    return {
        "gt_image": u(batch, s, s, 3) * 2 - 1,
        "inpaint": u(batch, s, s, 3) * 2 - 1,
        "mask": (u(batch, s, s, 1) > 0.3).to(torch.float32),
        "ref_clip": torch.randn((batch, clip, clip, 3), generator=g, device=device) * 0.3,
        "ref_face01": u(batch, 112, 112, 3),
        "landmarks": u(batch, 136),
    }


TRAIN_STEPS = 5  # timed steps after one warm-up step


def phase_train(model, seed: int) -> dict:
    """The main training path at full width; returns the kernels' launches over the timed steps."""
    import torch

    from vface_torch.pipelines.train import TrainConfig, make_optimizer, make_train_step

    cfg = TrainConfig()  # reconstruct_steps 4, ID weight 0.3, lr 1e-5, 10k warm-up; no LPIPS term
    opt, sched = make_optimizer(cfg, model)
    step = make_train_step(model, opt, sched, cfg)
    batch = train_batch(model, 1, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(batch, gen)
    torch.cuda.synchronize()
    log("train_warmup", wall_s=f"{time.perf_counter() - t0:.3f}")
    reset_counts()
    times, logs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        logs.append(step(batch, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    terms = {k: [float(x[k]) for x in logs] for k in logs[0]}
    log("train", config="sd_v1_inpaint 512^2 b1", reconstruct_steps=cfg.reconstruct_steps,
        id_loss_weight=cfg.id_loss_weight, trainable_params=n_train, steps=TRAIN_STEPS,
        ms_per_step=f"{sum(times) / len(times) * 1e3:.1f}",
        ms_steps=",".join(f"{t * 1e3:.1f}" for t in times), peak_gib=f"{peak:.2f}",
        **{k: ",".join(f"{x:.5f}" for x in v) for k, v in terms.items()})
    log("train_launches", **{k: f"{v / TRAIN_STEPS:g}" for k, v in launches.items()}, note="per step")
    if not all(math.isfinite(x) for v in terms.values() for x in v):
        raise SystemExit("chip_smoke: a training loss is not finite")
    changed = [n for n, p in model.named_parameters() if n in frozen and not torch.equal(p, frozen[n])]
    if changed:
        raise SystemExit(f"chip_smoke: frozen parameters changed in training: {changed[:5]}")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the training path launched no {missing} kernel")
    return launches


def _train_fixed(model, batch: int, seed: int, device="cuda") -> dict:
    """Fixed draws for a reproducible step: dropout on (so the uncond vector
    and, through the reconstruction, every conditioning head get gradients)."""
    import torch

    hl = model.cfg.latent_size
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda: torch.randn((batch, hl, hl, 4), generator=g, device=device)
    return {"t": torch.full((batch,), 613, dtype=torch.long, device=device), "noise": r(),
            "drop": torch.ones((batch, 1, 1), dtype=torch.bool, device=device), "enc_eps0": r(), "enc_eps1": r()}


def _loss_grads(model, batch, fixed, cfg):
    from vface_torch.pipelines.train import p_losses_face

    model.zero_grad(set_to_none=True)
    loss, logs = p_losses_face(model, batch, None, cfg, fixed)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    return {k: v.item() for k, v in logs.items()}, grads


TRAIN_GROUPS = ("unet.", "unet.in_0_0_attn.block_0.attn1.to_q.", "conditioner.clip_encoder.mapper2_",
                "conditioner.clip_encoder.final_ln2.", "conditioner.proj_out_source.",
                "conditioner.proj_out_target.", "conditioner.id_proj_out.", "conditioner.landmark_proj_out.",
                "conditioner.learnable_vector")


def phase_train_reference(model, seed: int) -> None:
    """One full-width step's gradients with the kernels and with their plain
    versions; every trainable group's gradient; the tiny fp32 loss and
    gradients on the card against the CPU."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.train import TrainConfig, p_losses_face, trainable_mask
    from vface_torch.utils.convert import init_params

    cfg = TrainConfig()
    batch, fixed = train_batch(model, 1, seed + 5), _train_fixed(model, 1, seed + 6)
    logs_k, grads_k = _loss_grads(model, batch, fixed, cfg)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    for group in TRAIN_GROUPS:
        names = [n for n in trainable if n.startswith(group)]
        norm = math.sqrt(sum(float(grads_k[n].float().norm()) ** 2 for n in names if n in grads_k))
        finite = all(bool(torch.isfinite(grads_k[n]).all()) for n in names if n in grads_k)
        log("train_grad_group", group=group, leaves=len(names), with_grad=sum(n in grads_k for n in names),
            l2=f"{norm:.4e}", finite=finite)
        if not names or not finite or not norm > 0:
            raise SystemExit(f"chip_smoke: trainable group {group} has no finite non-zero gradient")
    with plain_kernels():
        logs_p, grads_p = _loss_grads(model, batch, fixed, cfg)
    names = [n for n in grads_p if n.startswith("unet.")]
    diff = math.sqrt(sum(float((grads_k[n].float() - grads_p[n].float()).norm()) ** 2 for n in names))
    ref = math.sqrt(sum(float(grads_p[n].float().norm()) ** 2 for n in names))
    worst = max(names, key=lambda n: float((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm().clamp(min=1e-30)))
    worst_rel = float((grads_k[worst] - grads_p[worst]).norm() / grads_p[worst].norm())
    model.zero_grad(set_to_none=True)
    del grads_k, grads_p
    # the same bound as the full-width eval: the plain versions share the
    # kernels' rounding points; other fp32 sums move bf16 roundings by an ulp
    tol = 3e-2
    log("train_reference", unet_grad_rel_l2=f"{diff / ref:.3e}", tol=tol, leaves=len(names),
        worst_leaf=worst, worst_leaf_rel_l2=f"{worst_rel:.3e}",
        loss_kernels=f"{logs_k['loss']:.6f}", loss_plain=f"{logs_p['loss']:.6f}")
    if not diff / ref <= tol:
        raise SystemExit("chip_smoke: the training gradients with the kernels disagree with the plain path")

    # the tiny fp32 loss and gradients: card against CPU (the CPU run is held to JAX by the tests)
    tiny = ModelConfig.tiny(image_size=32)
    params = init_params(tiny, torch.Generator().manual_seed(seed), conditioner=True)
    cfg_t = TrainConfig(reconstruct_steps=2, id_loss_weight=0.3)
    out = {}
    for dev in ("cpu", "cuda"):
        m = VFaceModel(tiny, device=dev, conditioner=True)
        m.load_params(params)
        trainable_mask(m)
        tb = train_batch(m, 2, seed + 7, device="cpu")
        tf = _train_fixed(m, 2, seed + 8, device="cpu")
        tf["drop"] = torch.tensor([True, False])[:, None, None]
        mv = lambda d: {k: v.to(dev) for k, v in d.items()}
        m.zero_grad(set_to_none=True)
        loss, logs = p_losses_face(m, mv(tb), None, cfg_t, mv(tf))
        loss.backward()
        out[dev] = ({k: v.item() for k, v in logs.items()},
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.grad is not None})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    log_err = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    gmax = max(float(g.abs().max()) for g in gc.values())
    # each leaf within 1e-4 of its own peak, plus 1e-6 of the largest gradient:
    # the fp32 noise floor of leaves a GroupNorm zeroes in exact arithmetic
    ratio = max(float((gg[n] - gc[n]).abs().max()) / (1e-4 * float(gc[n].abs().max()) + 1e-6 * gmax) for n in gc)
    log("train_small_reference", config="tiny fp32 32^2 b2, recon 2 + ID", loss_max_rel_err=f"{log_err:.3e}",
        grad_err_over_tol=f"{ratio:.3f}", tol="1e-4", leaves=len(gc))
    if not (gg.keys() == gc.keys() and log_err <= 1e-4 and ratio <= 1.0):
        raise SystemExit("chip_smoke: the card's tiny training loss or gradients disagree with the CPU's")


def phase_profile_train(model, seed: int, path: str) -> None:
    """CUDA time by kernel over one full-width train step (torch.profiler)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vface_torch.pipelines.train import TrainConfig, p_losses_face

    cfg = TrainConfig()
    batch, fixed = train_batch(model, 1, seed + 9), _train_fixed(model, 1, seed + 10)

    def run():
        model.zero_grad(set_to_none=True)
        p_losses_face(model, batch, None, cfg, fixed)[0].backward()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))
    log("profile_train", what="loss + backward, no optimizer step", wall_ms=f"{wall_ms:.1f}",
        device_ms=f"{total:.1f}", device_busy=f"{total / wall_ms:.3f}", table=path)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


def kernels_line(rows: dict, launches: dict) -> dict:
    """One entry per kernel: the ds1 / largest site's numbers at top level, every site under "sites".

    ``launches`` is each kernel's count over its main path's run (K1-K3 the
    swap window, K4-K6 the timed train steps); K5's two kernels launch
    together, and its entry carries the dQ kernel's count."""
    out = []
    for name, sites in rows.items():
        head = dict(sites[0])
        head["max_abs_err"] = max(r["max_abs_err"] for r in sites)
        head["launches"] = launches[name + "_dq" if name == "flash_attention_bwd" else name]
        head["sites"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                             "max_abs_err")} for r in sites]
        head.pop("shape")
        out.append(head)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", metavar="PATH", help="also profile one sampling UNet eval, table to PATH")
    ap.add_argument("--profile-train", metavar="PATH", help="also profile one train step, table to PATH")
    args = ap.parse_args()

    import torch

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(batch=2 * FRAMES, vae_batch=FRAMES)
    rows.update(phase_train_kernels())
    model = build_model(SEED)
    launches = phase_swap(model, FRAMES, DDIM_STEPS, INVERSION_STEPS, SEED)
    phase_reference(model, FRAMES, SEED)
    phase_small_reference(SEED)
    if args.profile:
        phase_profile(model, FRAMES, SEED, args.profile)
    del model  # serving's model has no conditioner; training builds its own
    torch.cuda.empty_cache()
    model = build_model(SEED, conditioner=True)
    train_launches = phase_train(model, SEED)
    phase_train_reference(model, SEED)
    if args.profile_train:
        phase_profile_train(model, SEED, args.profile_train)
    launches.update({k: v for k, v in train_launches.items() if k not in SWAP_KERNELS})
    print(smi, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
