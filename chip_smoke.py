"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                      # every phase, as a CI smoke run
    python3 chip_smoke.py --profile out.txt    # and a profile of one UNet eval

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA C++ kernel of the port, one nvcc each, in parallel,
     plus the Triton kernel's compile on its first launch;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the shapes the swap path gives it, with the stated tolerance,
     its time, the plain version's time, the time of one PyTorch library call
     computing the same function (where one exists) and the card's bound;
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
  6. (``--profile PATH``) CUDA time by kernel of one sampling UNet eval;
  7. the card line, the ``kernels`` JSON line, then the result line.

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


KERNEL_MODULES = ("flash_attention", "geglu_ff", "gn_sums")


def _counters():
    import importlib

    return {name: importlib.import_module(f"vface_torch.ops.{name}") for name in KERNEL_MODULES}


@contextlib.contextmanager
def plain_kernels():
    """Route the models' three kernel call sites to the plain versions."""
    from unittest import mock

    from vface_torch.models import layers, unet
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    with mock.patch.object(unet, "flash_attention", FA.flash_attention_ref), \
            mock.patch.object(unet, "geglu_ff", FF.geglu_ff_ref), \
            mock.patch.object(layers, "gn_sums", GN.gn_sums_ref):
        yield


def build_model(seed: int):
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig.sd_v1_inpaint()
    t0 = time.perf_counter()
    model = VFaceModel(cfg, device="cuda")
    model.load_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(seed)))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("model", config="sd_v1_inpaint", dtype="bfloat16", params=n_params,
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
    mods = _counters()
    for m in mods.values():
        m.LAUNCHES = 0
    timings = {}
    t0 = time.perf_counter()
    out = pipe.swap_window(**inputs, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    n_inv = inv_steps - 1  # skip_last=1 at the recon-free operating point
    unet_evals = n_inv + steps
    log("swap", frames=frames, ddim_steps=steps, inversion_steps=inv_steps, inversion_evals=n_inv,
        image=f"{opts.image_size}^2", wall_s=f"{wall:.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in timings.items()},
        sample_ms_per_eval=f"{timings['sample'] / steps * 1e3:.1f}",
        invert_ms_per_eval=f"{timings['invert'] / max(n_inv, 1) * 1e3:.1f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    log("launches", **launches, unet_evals=unet_evals,
        per_unet_eval=",".join(f"{k}:{v / unet_evals:g}" for k, v in launches.items() if k != "gn_sums"),
        gn_sums_per_vae_pass=f"{launches['gn_sums'] / 3:g}")
    ok = (tuple(out.shape) == (frames, opts.image_size, opts.image_size, 3)
          and bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0)
    log("swap_check", shape=tuple(out.shape), dtype=out.dtype, finite=bool(torch.isfinite(out).all()),
        min=f"{float(out.min()):.4f}", max=f"{float(out.max()):.4f}", std=f"{float(out.float().std()):.4f}")
    if not ok:
        raise SystemExit("chip_smoke: swap output has the wrong shape, is not finite or leaves [0, 1]")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the swap path launched no {missing} kernel")
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


def kernels_line(rows: dict, launches: dict) -> dict:
    """One entry per kernel: the ds1 / largest site's numbers at top level, every site under "sites"."""
    out = []
    for name, sites in rows.items():
        head = dict(sites[0])
        head["max_abs_err"] = max(r["max_abs_err"] for r in sites)
        head["launches"] = launches.get(name, 0)
        head["sites"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                             "max_abs_err")} for r in sites]
        head.pop("shape")
        out.append(head)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", metavar="PATH", help="also profile one sampling UNet eval, table to PATH")
    args = ap.parse_args()

    import torch

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(batch=2 * FRAMES, vae_batch=FRAMES)
    model = build_model(SEED)
    launches = phase_swap(model, FRAMES, DDIM_STEPS, INVERSION_STEPS, SEED)
    phase_reference(model, FRAMES, SEED)
    phase_small_reference(SEED)
    if args.profile:
        phase_profile(model, FRAMES, SEED, args.profile)
    print(smi, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
