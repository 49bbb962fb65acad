"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                      # every phase, as a CI smoke run
    python3 chip_smoke.py --profile out.txt    # and a profile of one UNet eval
    python3 chip_smoke.py --profile-train out.txt  # and a profile of one train step
    python3 chip_smoke.py --previous parent.txt    # kernel rows also show the parent's times

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA C++ kernel of the port, one nvcc each, in parallel
     (each entry's registers, shared memory and spills from ptxas, and any
     wgmma serialization it reports; the attention and GEGLU kernels' dynamic
     shared memory; every entry of the forward attention (K1, K4, K6, K7),
     backward attention (K5, bf16 and fp32), fp32 attention (K7, K8, K10-K12
     on fp32 operands) and GEGLU libraries holds wgmma (HGMMA) and no
     mma.sync, but their split passes, which do no products, and none of them
     spills; K3's library, gn_sums, has no products);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, with the stated tolerance, its time, the plain version's time,
     the time of one PyTorch library call computing the same function (where
     one exists; the unfused route for the GEGLU kernels) and the card's
     bound (K1, K4 and K12 also print their exp floor: B*H*Nq*Nk ex2 at 16
     per clock per SM; the fp32 rows are bounded at the 3xTF32 line and also
     print the CUDA cores' FFMA line, fp32_ffma_ms): K1-K3 at the
     shapes the swap path gives them (K3 also prints its kernel's own device
     time from torch.profiler, device_ms, apart from the wrapper's host time), K4-K6 (the training attention) at the
     training shapes and K6, K5 at a ragged Nq != Nk, K5 bit for bit over two
     launches, K7-K9 (the rest of ``vface_tpu.ops``' kernels): K7 at the
     training shapes and a ragged Nq != Nk, at bf16 and at fp32, K8 at fp32
     up to the 1024^2 ds1 site (N = 16384) and at bf16, K9 at the ds4
     feed-forward (M = 3072, C = 1280) and the middle block's (M = 768);
     K10-K13 (the archived attention variants and the GEGLU row-tile sweep)
     at the kernel benches' shapes, K10-K12 also on fp32 operands; K5, K2 and
     K9 on fp32 operands (3xTF32) at the training and sampling shapes; with
     ``--previous`` (the parent's output in the same
     call) each row's log line also shows the parent's time at its shape
     (K13, whose tiles changed: the parent's fastest tile at the same
     operands), which the ``kernels`` line leaves out; ``k1_tiles`` lines time
     the forward kernel's two query tiles (128 and 192 rows) for K1, K4 and
     K6 at every batch the main paths give it (1, 2, 4, 6, 12 at ds1 and
     ds2) beside the tile the wrapper picks;
  4. bench: the kernel-bench entry points (``vface_torch.bench.attention``,
     ``.attn_v56``, ``.ff_tile``) at their own shapes, K10-K13's main path,
     with the launches of each kernel;
  5. swap: ``VideoSwapPipeline.swap_window`` at the SD-v1 inpainting widths
     (512^2, latent 64^2, bf16) on a 6-frame window with a random flow and
     seeded random weights, 50 inversion and 50 sampling steps (after a
     2 + 2-step warm-up), with the wall time per stage and the kernels'
     launch counts over that run; the output is checked for shape, finite
     values and the [0, 1] range;
  6. reference: one full-width UNet eval and one VAE decode with the kernels
     and with their plain versions swapped in, relative L2 error; the tiny
     fp32 config's swap_window and swap_video_frames on the card against the
     same calls on the CPU (the ones the tests hold to the JAX package);
  7. ops: the ``vface_torch.ops`` entry points at full width, counters reset
     first: ``flash_attention_v2`` forward and backward at the training shapes
     (K7, then K6 and K5; gradients against the plain versions under the
     precision gate), ``flash_attention``'s gradient at a ragged Nq != Nk
     (K4, K6, K5 against the plain path), ``flash_attention_v1`` at the N = 16384 site and
     ``flash_attention`` on fp32 operands (K8), ``geglu_ff_wide`` at ds4 (K9,
     against the unfused route on the model's weights),
     and one full-width UNet eval on the 3-chunk window batch per fusion mode
     added by the slice (replace, temporal, adain, mix, fft_vfixed), each
     against the same eval with the plain versions;
  7b. fp32_unet: the SD-v1 UNet at fp32 (``UNetConfig.sd_v1_inpaint`` at
     fp32: use_flash, use_fused_ff) with seeded weights: one eval without a
     gradient at the sampling batch (K8's tf32 attention, K2 and K9 fp32)
     and one loss + backward at batch 1 (the tf32 forward's STATS form, the
     tf32 recompute, K5's fp32 kernels, K2 fp32), each against the same
     call with the plain versions in relative L2; launches, wall time, peak
     memory;
  8. video: ``VideoSwapPipeline.swap_video_frames`` at full width with the
     conditioner (CLIP ViT-L/14, IR-50) and the aux nets (BiSeNet and RAFT
     seeded, the landmark net from its shipped weights) on a seeded 8-frame
     720x1280 clip at the reference operating point (50 + 50 steps, window 6,
     RAFT 20 iterations, parser 512): seconds per stage, frames/s, peak
     memory, launches, degenerate-quad fallbacks, the output's checks;
  9. train: the REFace training step (``make_optimizer`` / ``make_train_step``)
     at full width, batch 1 at 512^2, the reference operating point (4-step
     DDIM reconstruction with the ArcFace ID loss, LPIPS off), CLIP ViT-L/14
     and IRSE50 in the conditioner: one warm-up step and 5 timed steps, ms per
     step, peak memory, the loss terms and the kernels' launches per step;
 10. train_reference: one full-width step's UNet gradients with the kernels
     and with their plain versions, relative L2 error, and every trainable
     group's gradient finite and non-zero; the tiny fp32 ``p_losses_face``
     and its gradients on the card against the CPU;
 11. (``--profile PATH``, ``--profile-train PATH``) CUDA time by kernel of one
     sampling UNet eval (and the device time of its feed-forwards: K2's sites,
     the wide sites on K9, and the rest), of one train step;
 12. the card line, the ``kernels`` JSON line, then the result line.

TF32 is off for matmuls and convolutions throughout (the port's float32 ops,
the FSAI circulant and the warp, run in full float32), and so are cuBLAS's
reduced-precision bf16 reductions: the JAX package's bf16 products (the
unfused feed-forward at the wide sites) accumulate in fp32, and a split-K
reduction in bf16 would add a rounding that the reference does not have.

Exits non-zero, printing no result, without CUDA or without the port.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense tf32 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SMS = 0  # the card's streaming multiprocessors (set by phase_device)
EX2_PER_CLOCK = 16  # ex2 results per clock per SM (the SFU, compute capability 9.0)
SM_CLOCK_MHZ = 0.0  # the card's maximum SM clock, as nvidia-smi reads it (set by phase_device)
FRAMES = 6  # frames per window at the reference operating point
DDIM_STEPS = 50  # sampling steps at the reference operating point
INVERSION_STEPS = 50  # inversion steps (49 run: skip_last=1)
SEED = 0  # weights and inputs


PREVIOUS = {}  # (kernel, shape) -> ms in the parent's run (--previous)


def read_previous(path: str) -> dict:
    """{(kernel, shape): ms} from the ``kernels`` line of an earlier run's output."""
    for line in open(path, errors="replace"):
        if line.startswith('{"kernels"'):
            return {(k["name"], s["shape"]): s["ms"] for k in json.loads(line)["kernels"] for s in k["sites"]}
    raise SystemExit(f"chip_smoke: no kernels line in {path}")


def previous_ms(name: str, shape: str):
    """The parent's time at this kernel and shape; for K13, whose tiles changed,
    the parent's fastest tile at the same operands (and which one)."""
    if (name, shape) in PREVIOUS:
        return PREVIOUS[(name, shape)], shape
    base = shape.split(" tm")[0]
    tiles = [(ms, s) for (n, s), ms in PREVIOUS.items() if n == name and s.split(" tm")[0] == base]
    return min(tiles) if tiles else (None, None)


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


def device_ms(fn, kernel: str, reps: int = 10) -> float:
    """The device time of one call of ``fn`` in the kernels whose name holds
    ``kernel`` (torch.profiler's CUDA time over ``reps`` calls), without the
    host's dispatch; NaN where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    return sum(e.self_device_time_total for e in evs) / 1e3 / reps if evs else float("nan")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exp_floor(exps: float) -> float:
    """ms that ``exps`` exponentials take on the SFUs alone, at the card's
    maximum SM clock (read by :func:`phase_device`)."""
    return exps / (EX2_PER_CLOCK * SMS * SM_CLOCK_MHZ * 1e6) * 1e3


def tf32x3_bound(flops: float, nbytes: float, exps: float):
    """The bound of attention on fp32 operands: fp32-accurate products on the
    tensor cores are three tf32 terms (``flops`` at a third of the tf32 peak,
    165 TFLOP/s), beside the bytes and the exponentials' floor; the largest.
    The CUDA cores' FFMA line (:func:`ffma_ms`) is slower."""
    t, by = bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    e = exp_floor(exps)
    return (e, "operations") if e > t else (t, by)


def ffma_ms(flops: float) -> float:
    """ms of ``flops`` fp32 FLOPs at the CUDA cores' FFMA peak, the bound of
    fp32-accurate products off the tensor cores."""
    return flops / PEAK_FP32_FLOPS * 1e3


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global SM_CLOCK_MHZ, SMS
    SM_CLOCK_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, max_sm_clock_mhz=SM_CLOCK_MHZ, sms=SMS)
    return smi


def _demangle(names: list) -> list:
    """Kernel names demangled by the toolkit's cu++filt, without parameter types."""
    from vface_torch.ops import _native

    filt = subprocess.run([os.path.join(os.path.dirname(_native._nvcc()), "cu++filt"), "-p", *names],
                          capture_output=True, text=True)
    out = filt.stdout.splitlines() if filt.returncode == 0 else []
    return out if len(out) == len(names) else names


def phase_build() -> None:
    """Build every kernel; log each entry's registers, static shared memory and
    spill stores (ptxas), the dynamic shared memory of K1's and the GEGLU
    kernels' instantiations, and the tensor-core instructions of every entry of
    the attention and GEGLU libraries (SASS): wgmma (HGMMA) and no mma.sync
    (HMMA), but for the fp32 attention's split pass, which does no products."""
    import ctypes

    from vface_torch.ops import _native

    t0 = time.perf_counter()
    built = _native.build()
    log("build", sources=",".join(_native.SOURCES), built=",".join(built) or "none",
        seconds=f"{time.perf_counter() - t0:.1f}")
    spills = {}
    for name in _native.SOURCES:  # the compiler's report, kept beside each library
        text = _native.lib_path(name).with_suffix(".log").read_text()
        entries, cur = [], None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                cur = [line.split("'")[1], 0, 0, 0]
                entries.append(cur)
            elif "spill stores" in line and cur:
                cur[2] = int(line.split("bytes spill stores")[0].split(",")[-1])
            elif "Used" in line and cur:
                cur[1] = int(line.split("Used")[1].split()[0])
                if "bytes smem" in line:
                    cur[3] = int(line.split("bytes smem")[0].split(",")[-1])
        names = _demangle([e[0] for e in entries])
        spills[name] = sum(e[2] for e in entries)
        log("ptxas", source=name, entries=len(entries), spill_store_bytes=spills[name],
            registers=" | ".join(f"{n}: {r} regs, {sm} B smem{f', spill {sp} B' if sp else ''}"
                                 for n, (_, r, sp, sm) in zip(names, entries)))
        for line in text.splitlines():
            if "arning" in line or "Performance Loss" in line:
                log("ptxas_warning", source=name, line=line.strip())
    smem = _native.function("flash_attention", "vface_flash_attention_smem_bytes", [ctypes.c_int] * 2)
    log("k1_dynamic_smem", **{f"dh{dh}_nc{nc}": smem(dh, nc) for dh in (8, 40, 80) for nc in (2, 3)})
    smem = _native.function("flash_attention_bwd", "vface_flash_attention_bwd_smem_bytes", [ctypes.c_int])
    log("k5_dynamic_smem", **{f"dh{dh}": smem(dh) for dh in (8, 40, 80)})
    smem = _native.function("flash_attention_f32", "vface_flash_attention_f32_smem_bytes", [ctypes.c_int])
    log("k8_dynamic_smem", **{f"dh{dh}": smem(dh) for dh in (16, 32, 40, 80)})
    smem = _native.function("geglu_ff", "vface_geglu_ff_smem_bytes", [ctypes.c_int] * 3)
    log("geglu_dynamic_smem", **{f"fused_c{c}_tm{tm}": smem(c, tm, 0) for c, tm in ((64, 128), (320, 64), (320, 128))},
        **{f"gemm{gm}": smem(0, 128, gm) for gm in (1, 2)})
    smem = _native.function("flash_attention_bwd_f32", "vface_flash_attention_bwd_f32_smem_bytes", [ctypes.c_int] * 2)
    log("k5_f32_dynamic_smem", **{f"dh{dh}_{k}": smem(dh, i) for dh in (16, 32, 40, 80) for i, k in enumerate(("dq", "dkv"))})
    wgmma_sources = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_f32", "flash_attention_f32", "geglu_ff")
    spilled = [name for name in wgmma_sources if spills[name]]
    if spilled:
        raise SystemExit(f"chip_smoke: the wgmma kernels of {spilled} spill registers")
    for name in wgmma_sources:
        sass = subprocess.run([os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump"), "-sass",
                               str(_native.lib_path(name))], capture_output=True, text=True, check=True)
        counts, fn = {}, None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = [0, 0]
            elif fn and "HGMMA" in line:
                counts[fn][0] += 1
            elif fn and "HMMA" in line:
                counts[fn][1] += 1
        names = _demangle(list(counts))
        log("sass", source=name,
            entries=" | ".join(f"{n}: {c[0]} HGMMA, {c[1]} HMMA" for n, c in zip(names, counts.values())))
        # the split passes of the fp32 kernels (split_kv_kernel, split_planes_kernel, split_tf32_kernel) do no products
        if not counts or any((c[0] == 0 and "split_" not in fn) or c[1] for fn, c in counts.items()):
            raise SystemExit(f"chip_smoke: every entry of {name} must run wgmma (HGMMA) and no mma.sync (HMMA)")


def _row(name, route, source, replaces, errs, tol, ms, plain_ms, lib_ms, bnd, shape, exp_ms=None, ffma=None,
         extra=None):
    """errs = (max abs error, max relative error); tol = ("abs" or "rel", limit);
    exp_ms: the attention forward's exp floor (:func:`exp_floor`), beside the bound;
    ffma: an fp32 row's FFMA line (:func:`ffma_ms`), beside its tf32 bound;
    extra: other figures for the log line. All go on the log line only, as
    does the parent's time at the same shape with ``--previous``
    (:func:`previous_ms`): the returned row holds this run's measurements and
    ``bound_ms``."""
    checked = errs[0] if tol[0] == "abs" else errs[1]
    floor = {} if exp_ms is None else {"exp_floor_ms": f"{exp_ms:.4f}"}
    floor.update(extra or {})
    if ffma is not None:
        floor["fp32_ffma_ms"] = f"{ffma:.4f}"
    prev, prev_shape = previous_ms(name, shape)
    if prev is not None:
        floor["previous_ms"] = f"{prev:.4f}"
        if prev_shape != shape:
            floor["previous_shape"] = prev_shape.replace(" ", "_")
    log("kernel", name=name, shape=shape, max_abs_err=f"{errs[0]:.3e}", max_rel_err=f"{errs[1]:.3e}",
        tol=f"{tol[0]}<={tol[1]:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.4f}", bound_ms=f"{bnd[0]:.4f}",
        bound_by=bnd[1], **floor)
    if not checked <= tol[1]:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version: {checked} > {tol}")
    return {"name": name, "route": route, "source": source, "replaces": replaces, "shape": shape,
            "max_abs_err": errs[0], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib_ms}


def equal_k6(got, k6, name: str, shape: str) -> None:
    """K8's function on bf16 operands runs on K6's kernel (P at fp32
    precision): its output must be K6's bit for bit. The 2-ulp limit of its
    row cannot tell that from P rounded to bf16 (K1's kernel)."""
    import torch

    same = torch.equal(got, k6)
    log("kernel_k6_check", name=name, shape=shape, equals_k6=same)
    if not same:
        raise SystemExit(f"chip_smoke: {name} on bf16 operands at {shape} is not K6's kernel's output")


def _ff_bound(m: int, c: int, inner: int):
    """GEGLU's bound: 6*M*C*I FLOPs at the bf16 peak, or x, the weights, the biases and out once."""
    return bound(6.0 * m * c * inner, (2 * m * c + 3 * c * inner + 2 * inner + c) * 2)


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


def kernel_errs(name: str, args: tuple, got):
    """(errs, tol) of K1's, K2's, K3's or K9's output ``got`` on ``args`` against
    its plain version on the same inputs. K1, K2 and K9: 2 bf16 ulps at the output's
    peak (both round the same fp32 values to bf16; sums in another order may
    flip one rounding of P, of an intermediate or of the output; at ds1 ~2e-3,
    while dropping one K/V tile errs by ~1e-1). K3: fp32 sums in another
    order, relative 1e-5 of each row's sum of |x| (the sum may be near 0) and
    of the sum of squares itself."""
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    if name == "gn_sums":
        (x,), (s1, s2) = args, got
        r1, r2 = GN.gn_sums_ref(x)
        absx = x.float().abs().sum(dim=(2, 3)).clamp_min(1e-30)
        return ((max((s1 - r1).abs().max().item(), (s2 - r2).abs().max().item()),
                 max(((s1 - r1).abs() / absx).max().item(), ((s2 - r2).abs() / r2.clamp_min(1e-30)).max().item())),
                ("rel", 1e-5))
    want = {"flash_attention": FA.flash_attention_ref, "geglu_ff": FF.geglu_ff_ref,
            "geglu_ff_wide": FF.geglu_ff_ref}[name](*args)
    return _errs(got, want), ("abs", 2 * bf16_ulp(want.float().abs().max().item()))


@contextlib.contextmanager
def checked_sites(phase: str):
    """Hold the models' K1, K2, K3 and K9 call sites to their plain versions on
    their own inputs, at every input signature the run gives them: the first
    call at each (kernel, shapes, dtype, heads) is compared by
    :func:`kernel_errs`, one ``kernel_site`` line each, and a disagreement
    fails. Yields {kernel: signatures checked}."""
    from unittest import mock

    import torch

    from vface_torch.models import layers, unet

    seen = {name: set() for name in SWAP_KERNELS}

    def spy(name, kernel):
        def call(*args):
            out = kernel(*args)
            sig = (str(args[0].dtype),) + tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if sig not in seen[name]:
                seen[name].add(sig)
                errs, tol = kernel_errs(name, args, out)
                checked = errs[0] if tol[0] == "abs" else errs[1]
                log("kernel_site", path=phase, name=name, dtype=sig[0],
                    shapes=",".join(str(a).replace(" ", "") for a in sig[1:]),
                    max_abs_err=f"{errs[0]:.3e}", max_rel_err=f"{errs[1]:.3e}", tol=f"{tol[0]}<={tol[1]:.3e}")
                if not checked <= tol[1]:
                    raise SystemExit(f"chip_smoke: {name} disagrees with its plain version on the {phase} "
                                     f"path at {sig}: {checked} > {tol}")
            return out
        return call

    with mock.patch.object(unet, "flash_attention", spy("flash_attention", unet.flash_attention)), \
            mock.patch.object(unet, "geglu_ff", spy("geglu_ff", unet.geglu_ff)), \
            mock.patch.object(unet, "geglu_ff_wide", spy("geglu_ff_wide", unet.geglu_ff_wide)), \
            mock.patch.object(layers, "gn_sums", spy("gn_sums", layers.gn_sums)):
        yield seen
    log("kernel_sites", path=phase, **{name: len(sigs) for name, sigs in seen.items()})
    missing = [name for name, sigs in seen.items() if not sigs]
    if missing:
        raise SystemExit(f"chip_smoke: the {phase} path called no {missing} kernel")


def phase_kernels(batch: int, vae_batch: int) -> dict:
    """Each kernel against its plain version at the swap path's shapes; returns the rows.

    K1 and K2 at the sampling batch (2 chunks x the window), K3 at the VAE's
    (the window). :func:`checked_sites` holds them at every other shape the
    swap and video paths give them.
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

    # K1 at the two self-attention sites it serves: ds1 (dh 40) and ds2 (dh 80)
    fa_rows = []
    for n, c in ((4096, 320), (1024, 640)):
        h = 8
        dh = c // h
        q, k, v = randn(batch, n, c), randn(batch, n, c), randn(batch, n, c)
        errs, tol = kernel_errs("flash_attention", (q, k, v, h), FA.flash_attention(q, k, v, h))
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, h))
        plain_ms = cuda_ms(lambda: FA.flash_attention_ref(q, k, v, h), reps=3, warmup=1)
        split = lambda t: t.view(batch, n, h, dh).transpose(1, 2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)))
        bnd = bound(4.0 * batch * h * n * n * dh, 4 * q.numel() * 2)
        fa_rows.append(_row("flash_attention", "cuda", "vface_torch/csrc/flash_attention.cu",
                            "vface_tpu/ops/pallas_attention.py:547", errs, tol, ms, plain_ms,
                            lib_ms, bnd, f"({batch},{n},{c})h{h}", exp_floor(batch * h * n * n)))
    rows["flash_attention"] = fa_rows

    # K2 at the ds1 and ds2 transformer feed-forwards; the library column is
    # the unfused route (two cuBLAS bf16 products)
    ff_rows = []
    for n, c in ((4096, 320), (1024, 640)):
        inner = 4 * c
        x = randn(batch * n, c)
        wp, bp = randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1)
        wo, bo = randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1)
        errs, tol = kernel_errs("geglu_ff", (x, wp, bp, wo, bo), FF.geglu_ff(x, wp, bp, wo, bo))
        ms = cuda_ms(lambda: FF.geglu_ff(x, wp, bp, wo, bo))
        plain_ms = cuda_ms(lambda: FF.geglu_ff_ref(x, wp, bp, wo, bo), reps=3, warmup=1)
        unfused_ms = cuda_ms(lambda: FF.geglu_ff_unfused(x, wp, bp, wo, bo))
        m = batch * n
        ff_rows.append(_row("geglu_ff", "cuda", "vface_torch/csrc/geglu_ff.cu",
                            "vface_tpu/ops/pallas_ff.py:70", errs, tol, ms, plain_ms, unfused_ms,
                            _ff_bound(m, c, inner), f"({m},{c})I{inner}"))
    rows["geglu_ff"] = ff_rows
    # K2's row tile at C = 320 (FF.k2_tile) at every M the main paths give it:
    # batches 1 (train step), 2 and 4 (the 2-frame window), 6 (inversion) and
    # 12 (sampling) at ds1; both tiles through K13, which launches K2's kernel
    for b in (1, 2, 4, 6, 12):
        c, m = 320, b * 4096
        inner = 4 * c
        args = (randn(m, c), randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1),
                randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1))
        forms = {f"fused_tm{tm}_ms": f"{cuda_ms(lambda: FF.geglu_ff_split(*args, tm)):.4f}" for tm in FF.SPLIT_TILES[c]}
        log("k2_forms", shape=f"({m},{c})I{inner}", k2_ms=f"{cuda_ms(lambda: FF.geglu_ff(*args)):.4f}",
            k2_tile=FF.k2_tile(m, dev), unfused_ms=f"{cuda_ms(lambda: FF.geglu_ff_unfused(*args)):.4f}", **forms)

    # K3 at the VAE's largest and smallest eligible GroupNorm sites on the
    # crops, and at the largest on the video path's HD frames (the background
    # trick): 16384-element rows (one CTA each), 262,144 and 921,600 (a
    # cluster of 8 CTAs each); the event time holds the wrapper's host time,
    # device_ms the kernel's alone
    gn_rows = []
    for c, hh, ww in ((128, 512, 512), (512, 128, 128), (128, 720, 1280)):
        x = randn(vae_batch, c, hh, ww)
        errs, tol = kernel_errs("gn_sums", (x,), GN.gn_sums(x))
        ms = cuda_ms(lambda: GN.gn_sums(x))
        plain_ms = cuda_ms(lambda: GN.gn_sums_ref(x))
        lib_ms = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3)))
        bnd = bound(2.0 * x.numel(), x.numel() * 2 + 2 * vae_batch * c * 4, PEAK_FP32_FLOPS)
        dev_ms = device_ms(lambda: GN.gn_sums(x), "gn_sums")
        gn_rows.append(_row("gn_sums", "cuda", "vface_torch/csrc/gn_sums.cu",
                            "vface_tpu/models/layers.py:45", errs, tol, ms, plain_ms, lib_ms, bnd,
                            f"({vae_batch},{c},{hh},{ww})", extra={"device_ms": f"{dev_ms:.4f}"}))
    rows["gn_sums"] = gn_rows
    return rows


SWAP_KERNELS = ("flash_attention", "geglu_ff", "geglu_ff_wide", "gn_sums")  # K9: the UNet's wide sites
TRAIN_KERNELS = ("flash_attention_stats", "flash_attention_fp32", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "geglu_ff", "gn_sums")


OPS_KERNELS = ("flash_attention_v2_stats", "flash_attention_v1")
BENCH_KERNELS = ("flash_attention_v3", "flash_attention_v4", "flash_attention_v6", "geglu_ff_split")


def kernel_counts() -> dict:
    """Every kernel's launches since the last reset, by name."""
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    return {**FA.LAUNCHES, "geglu_ff": FF.LAUNCHES, "geglu_ff_wide": FF.WIDE_LAUNCHES,
            "geglu_ff_split": FF.SPLIT_LAUNCHES, "geglu_ff_f32": FF.F32_LAUNCHES,
            "geglu_ff_wide_f32": FF.WIDE_F32_LAUNCHES, "gn_sums": GN.LAUNCHES}


def reset_counts() -> None:
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    for name in FA.LAUNCHES:
        FA.LAUNCHES[name] = 0
    FF.LAUNCHES = 0
    FF.WIDE_LAUNCHES = 0
    FF.SPLIT_LAUNCHES = 0
    FF.F32_LAUNCHES = 0
    FF.WIDE_F32_LAUNCHES = 0
    GN.LAUNCHES = 0


@contextlib.contextmanager
def plain_kernels():
    """Route the models' kernel call sites to the plain versions: the
    attention's forward and backward (K1, or K4 with K6 and K5), GEGLU's
    forward (its backward is plain already) at K2's and K9's sites, and the
    GroupNorm sums."""
    from unittest import mock

    from vface_torch.models import layers, unet
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    with mock.patch.object(unet, "flash_attention", FA.flash_attention_ref), \
            mock.patch.object(unet, "geglu_ff", FF.geglu_ff_ref), \
            mock.patch.object(unet, "geglu_ff_wide", FF.geglu_ff_ref), \
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
    # loads land here, not in the measured drive below; it runs every kernel
    # call site at the measured drive's shapes, each held to its plain version
    t0 = time.perf_counter()
    short = SwapOptions(ddim_steps=2, inversion_steps=2, window=frames, image_size=model.cfg.image_size)
    with checked_sites("swap"):
        VideoSwapPipeline(model, short, device="cuda").swap_window(**inputs)
    torch.cuda.synchronize()
    log("warmup", ddim_steps=2, inversion_steps=2, wall_s=f"{time.perf_counter() - t0:.3f}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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


def _ff_ranges(model):
    """A profiler range around every feed-forward of the UNet, through module
    hooks: ``ff_k2`` at K2's sites (C <= 768), ``ff_wide`` at the wide ones
    (K9 without a gradient, else the unfused route); returns the hooks' handles."""
    import torch

    from vface_torch.models.unet import FeedForward

    def enter(mod, args):
        mod._range = torch.profiler.record_function("ff_k2" if mod.use_fused else "ff_wide")
        mod._range.__enter__()

    def leave(mod, args, out):
        mod._range.__exit__(None, None, None)

    ffs = [m for m in model.unet.modules() if isinstance(m, FeedForward)]
    return [h for m in ffs for h in (m.register_forward_pre_hook(enter), m.register_forward_hook(leave))]


def phase_profile(model, frames: int, seed: int, path: str) -> None:
    """CUDA time by kernel for one 2-chunk sampling UNet eval at full width
    (torch.profiler); the top rows are printed, the whole table goes to ``path``.
    The eval is profiled once more with a range around each feed-forward,
    splitting its device time into K2's sites, the wide sites (K9; the range
    holds the feed-forward's weight casts too) and the rest; then the
    video's 2-frame window batches (b = 4 sampling, b = 2 inversion): wall,
    device time and busy share of one eval each."""
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

    handles = _ff_ranges(model)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    for h in handles:
        h.remove()
    # each range shows on the device as an annotation spanning its kernels: a
    # kernel that starts inside a span is that range's, and the annotations
    # themselves are no device time
    ranges = ("ff_k2", "ff_wide")
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e.time_range for e in device if e.name not in ranges]
    total_ff = sum(k.elapsed_us() for k in kernels) / 1e3
    split = {}
    for key in ranges:
        spans = [e.time_range for e in device if e.name == key]
        inside = [k for k in kernels if any(s.start <= k.start < s.end for s in spans)]
        split[key] = (len(spans), sum(k.elapsed_us() for k in inside) / 1e3)
    log("profile_ff", batch=2 * frames, device_ms=f"{total_ff:.3f}", k2_sites=split["ff_k2"][0],
        k2_ms=f"{split['ff_k2'][1]:.3f}", wide_route="k9", wide_sites=split["ff_wide"][0],
        wide_ms=f"{split['ff_wide'][1]:.3f}", rest_ms=f"{total_ff - split['ff_k2'][1] - split['ff_wide'][1]:.3f}")

    # the video's short window (2 frames): its sampling batch, b = 4, and its
    # inversion batch, b = 2; wall against device time
    for b in (4, 2):
        xs, tss, cs = x9[:b], ts[:b], ctx[:b]
        inj_b = inj if b == 4 else None
        fl = flow[:1] if b == 4 else None
        run_b = lambda: model.apply_model(xs, tss, cs, flow=fl, injection=inj_b)
        with torch.inference_mode():
            run_b()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_b()
            torch.cuda.synchronize()
            wall_b = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_b()
                torch.cuda.synchronize()
        dev_b = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        log("profile_short_window", batch=b, hooks="2-chunk FSAI + FGATS" if b == 4 else "none (inversion)",
            wall_ms=f"{wall_b:.1f}", device_ms=f"{dev_b:.1f}", device_busy=f"{dev_b / wall_b:.3f}")


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


# the ragged cross-attention case of K6, K7 and K5 (dh 40): Nq and Nk of
# neither tile's multiple, queries 4x the keys
RAGGED_NQ, RAGGED_NK = 4096 + 17, 1024 + 5


def _shape(b: int, nq: int, nk: int, c: int, h: int) -> str:
    return f"({b},{nq},{c})h{h}" if nq == nk else f"({b},{nq}x{nk},{c})h{h}"


def phase_train_kernels() -> dict:
    """K4, K6 and K5 against their plain versions at the training shapes, batch 1:
    ds1 (1, 4096, 320) and ds2 (1, 1024, 640), 8 heads, bf16; K6 and K5 also
    at a ragged Nq != Nk (queries (1, 4113, 320) over keys (1, 1029, 320)).
    Limit: 2 bf16 ulps at the peak of each output (K4 also checks m and l to
    1e-5 relative, and its output against K1's bit for bit); K6 and K5 also
    pass :func:`precision_gate`; K5's two launches on the same inputs are
    equal bit for bit.

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
    fwd_src = "vface_torch/csrc/flash_attention.cu"
    for nq, nk, c in ((4096, 4096, 320), (1024, 1024, 640), (RAGGED_NQ, RAGGED_NK, 320)):
        h, b = 8, 1
        dh = c // h
        q, do = randn(b, nq, c), randn(b, nq, c)
        k, v = randn(b, nk, c), randn(b, nk, c)
        shape = _shape(b, nq, nk, c, h)
        split = lambda t: t.view(b, -1, h, dh).transpose(1, 2)
        n2dh = float(b * h * nq * nk * dh)
        act_q, act_k = q.numel() * 2, k.numel() * 2  # bytes of one bf16 query-side / key-side tensor
        stat = b * h * nq * 4  # bytes of one fp32 (B*H, Nq) statistic

        out, m, l = FA.flash_attention_stats(q, k, v, h)
        want, wm, wl = FA.flash_attention_stats_ref(q, k, v, h)
        torch.cuda.synchronize()
        rel_ml = max(((m - wm).abs() / wm.abs().clamp(min=1e-30)).max().item(),
                     ((l - wl).abs() / wl).max().item())
        if not rel_ml <= 1e-5:
            raise SystemExit(f"chip_smoke: flash_attention_stats m/l disagree: {rel_ml} > 1e-5")
        if not torch.equal(out, FA.flash_attention(q, k, v, h)):
            raise SystemExit("chip_smoke: flash_attention_stats's output is not K1's bit for bit")
        if nq == nk:  # K4's rows: the training sites
            rows["flash_attention_stats"].append(_row(
                "flash_attention_stats", "cuda", fwd_src, "vface_tpu/ops/pallas_attention.py:658", _errs(out, want),
                ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
                cuda_ms(lambda: FA.flash_attention_stats(q, k, v, h)),
                cuda_ms(lambda: FA.flash_attention_stats_ref(q, k, v, h), reps=3, warmup=1),
                cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))),
                bound(4.0 * n2dh, 2 * act_q + 2 * act_k + 2 * stat), shape, exp_floor(b * h * nq * nk)))
        log("kernel_stats_check", shape=shape, m_l_max_rel_err=f"{rel_ml:.3e}", tol="1e-05",
            equals_k1="bitwise")

        o6 = FA.flash_attention_fp32(q, k, v, h)
        want6 = FA.flash_attention_fp32_ref(q, k, v, h)
        torch.cuda.synchronize()
        # the yardstick: K4's plain version, which rounds P to bf16 alone
        precision_gate("flash_attention_fp32", shape, o6, want6, want)
        qf, kf, vf = (split(t).float() for t in (q, k, v))
        rows["flash_attention_fp32"].append(_row(
            "flash_attention_fp32", "cuda", fwd_src, "vface_tpu/ops/pallas_attention.py:143", _errs(o6, want6),
            ("abs", 2 * bf16_ulp(want6.float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_fp32(q, k, v, h)),
            cuda_ms(lambda: FA.flash_attention_fp32_ref(q, k, v, h), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf)),
            bound(4.0 * n2dh, 2 * act_q + 2 * act_k), shape))
        del qf, kf, vf

        dd = FA.rowsum_do_o(do, o6, h)
        got = FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)
        again = FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)
        want5 = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h)
        torch.cuda.synchronize()
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        # each gradient against 2 ulps of its own peak; the row reports the worst margin
        ratios = [_errs(gi, wi)[0] / (2 * bf16_ulp(wi.float().abs().max().item())) for gi, wi in zip(got, want5)]
        worst = max(range(3), key=lambda i: ratios[i])
        errs = _errs(got[worst], want5[worst])
        dq_ms = cuda_ms(lambda: FA._launch_bwd("flash_attention_bwd_dq", "vface_flash_attention_bwd_dq_bf16",
                                               FA._DQ_ARGS, q, k, v, do, h, (m, l, dd), (again[0],)))
        dkv_ms = cuda_ms(lambda: FA._launch_bwd("flash_attention_bwd_dkv", "vface_flash_attention_bwd_dkv_bf16",
                                                FA._DKV_ARGS, q, k, v, do, h, (m, l, dd), again[1:]))
        log("kernel_bwd_check", shape=shape, dq_dk_dv_err_over_tol=",".join(f"{r:.3f}" for r in ratios),
            two_launches="bitwise" if same else "differ", dq_ms=f"{dq_ms:.4f}", dkv_ms=f"{dkv_ms:.4f}")
        if not same:
            raise SystemExit("chip_smoke: two launches of flash_attention_bwd differ")
        yard = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h, round_p=True)
        for gname, gi, wi, yi in zip(("dq", "dk", "dv"), got, want5, yard):
            precision_gate(f"flash_attention_bwd.{gname}", shape, gi, wi, yi)
        leaves = [split(t).detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        dsplit = split(do)
        rows["flash_attention_bwd"].append(_row(
            "flash_attention_bwd", "cuda", "vface_torch/csrc/flash_attention_bwd.cu",
            "vface_tpu/ops/pallas_attention.py:444", errs,
            ("abs", 2 * bf16_ulp(want5[worst].float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)),
            cuda_ms(lambda: FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h), reps=3, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dsplit, retain_graph=True)),
            bound(10.0 * n2dh, 3 * act_q + 4 * act_k + 3 * stat), shape))
        del leaves, sdpa_out, got, again, want5, yard
    return rows


def phase_f32_kernels() -> dict:
    """K5, K2 and K9 on fp32 operands (3xTF32) against their plain versions on
    the card; returns the rows.

    K5 at the training shapes on fp32, (1, 4096, 320) and (1, 1024, 640) h8
    and the ragged 4113 x 1029, on the m and l of K4's fp32 form (the tf32
    kernel's STATS) and D from the tf32 recompute: each gradient within 1e-5
    of its peak (tests/test_torch_kernels.py calibrates the limit: three tf32
    terms per product meet it, one term or a dropped lo term miss it), two
    launches equal bit for bit; the split pass, dQ and dK/dV kernels timed
    apart (kernel_bwd_f32_check). K2 at the sampling batch's ds1 and ds2
    feed-forwards and K9 at ds4's and the middle block's, within 1e-5 of the
    output's peak, two launches equal bit for bit.

    Bounds: the FLOPs as three tf32 products at the tf32 peak (165 TFLOP/s of
    fp32-accurate products) or the bytes (fp32), and for K5 the exp floor (P
    is computed in both kernels: 2*B*H*Nq*Nk ex2); the CUDA cores' FFMA line
    on the log line. Library: SDPA's autograd backward on fp32 inputs (K5), the
    unfused route on fp32 (two cuBLAS SGEMMs, TF32 off; K2, K9)."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA
    from vface_torch.ops import geglu_ff as FF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    rows = {"flash_attention_bwd_f32": [], "geglu_ff_f32": [], "geglu_ff_wide_f32": []}
    for nq, nk, c in ((4096, 4096, 320), (1024, 1024, 640), (RAGGED_NQ, RAGGED_NK, 320)):
        h, b = 8, 1
        dh = c // h
        q, do = randn(b, nq, c), randn(b, nq, c)
        k, v = randn(b, nk, c), randn(b, nk, c)
        shape = _shape(b, nq, nk, c, h) + " fp32"
        _, m, l = FA.flash_attention_stats(q, k, v, h)
        dd = FA.rowsum_do_o(do, FA.flash_attention_fp32(q, k, v, h), h)
        got = FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)
        again = FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)
        want = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h)
        torch.cuda.synchronize()
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        rels = [_errs(gi, wi)[1] for gi, wi in zip(got, want)]
        worst = max(range(3), key=lambda i: rels[i])
        planes = FA._bwd_f32_planes(q, k, v, do, h)
        split_ms = cuda_ms(lambda: FA._bwd_f32_planes(q, k, v, do, h))
        dq_ms = cuda_ms(lambda: FA._launch_bwd_f32("flash_attention_bwd_dq_f32", planes, q, k, h, (m, l, dd),
                                                   (again[0],)))
        dkv_ms = cuda_ms(lambda: FA._launch_bwd_f32("flash_attention_bwd_dkv_f32", planes, q, k, h, (m, l, dd),
                                                    again[1:]))
        log("kernel_bwd_f32_check", shape=shape.replace(" ", "_"), dq_dk_dv_rel_err=",".join(f"{r:.3e}" for r in rels),
            tol="1e-05", two_launches="bitwise" if same else "differ", split_ms=f"{split_ms:.4f}",
            dq_ms=f"{dq_ms:.4f}", dkv_ms=f"{dkv_ms:.4f}")
        if not same:
            raise SystemExit("chip_smoke: two launches of the fp32 flash_attention_bwd differ")
        split = lambda t: t.view(b, -1, h, dh).transpose(1, 2)
        leaves = [split(t).detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        dsplit = split(do)
        flops = 10.0 * b * h * nq * nk * dh  # S, dP, dQ, dK, dV
        nbytes = (3 * q.numel() + 4 * k.numel()) * 4 + 3 * b * h * nq * 4
        rows["flash_attention_bwd_f32"].append(_row(
            "flash_attention_bwd_f32", "cuda", "vface_torch/csrc/flash_attention_bwd_f32.cu",
            "vface_tpu/ops/pallas_attention.py:444", _errs(got[worst], want[worst]), ("rel", 1e-5),
            cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, do, m, l, dd, h)),
            cuda_ms(lambda: FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h), reps=3, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dsplit, retain_graph=True)),
            tf32x3_bound(flops, nbytes, 2 * b * h * nq * nk), shape, ffma=ffma_ms(flops)))
        del q, k, v, do, got, again, want, planes, leaves, sdpa_out

    for name, fn, line, sites in (("geglu_ff_f32", FF.geglu_ff, 70, ((12 * 4096, 320), (12 * 1024, 640))),
                                  ("geglu_ff_wide_f32", FF.geglu_ff_wide, 120, ((12 * 256, 1280), (12 * 64, 1280)))):
        for m, c in sites:
            inner = 4 * c
            args = (randn(m, c), randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1),
                    randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1))
            got, again = fn(*args), fn(*args)
            want = FF.geglu_ff_ref(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise SystemExit(f"chip_smoke: two launches of {name} differ")
            flops = 6.0 * m * c * inner
            rows[name].append(_row(
                name, "cuda", "vface_torch/csrc/geglu_ff.cu", f"vface_tpu/ops/pallas_ff.py:{line}", _errs(got, want),
                ("rel", 1e-5), cuda_ms(lambda: fn(*args)), cuda_ms(lambda: FF.geglu_ff_ref(*args), reps=3, warmup=1),
                cuda_ms(lambda: FF.geglu_ff_unfused(*args)),
                bound(3.0 * flops, (2 * m * c + 3 * c * inner + 2 * inner + c) * 4, PEAK_TF32_FLOPS),
                f"({m},{c})I{inner} fp32", ffma=ffma_ms(flops)))
            del args, got, again, want
    torch.cuda.empty_cache()
    return rows


def phase_k1_tiles() -> None:
    """The forward kernel's two query tiles (``consumers`` 2 and 3: 128 and 192
    rows per CTA) timed for K1, K4 and K6 at every batch the main paths give
    it, at ds1 and ds2 (8 heads), beside the tile ``k1_consumers`` picks."""
    import torch

    from vface_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for n, c in ((4096, 320), (1024, 640)):
        for b in (1, 2, 4, 6, 12):
            h = 8
            dh = c // h
            q, k, v = (torch.randn((b, n, c), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
            out = torch.empty_like(q)
            m = torch.empty((b * h, n), dtype=torch.float32, device=dev)
            l = torch.empty_like(m)
            times = {}
            for name, outs, split in (("k1", (out,), False), ("k4", (out, m, l), False), ("k6", (out,), True)):
                for nc in FA.built_consumers(split, dh):
                    launch = lambda: FA._launch_fwd("flash_attention", q, k, v, h, outs, split, nc)
                    times[f"{name}_nc{nc}_ms"] = f"{cuda_ms(launch):.4f}"
            log("k1_tiles", shape=f"({b},{n},{c})h{h}", picks=FA.k1_consumers(b * h, n, dev, False, dh),
                picks_k6=FA.k1_consumers(b * h, n, dev, True, dh), **times)
            del q, k, v, out, m, l
    reset_counts()


def phase_ops_kernels() -> dict:
    """K7, K8 and K9 against their plain versions on the card; returns the rows.

    K7 (bf16, K6's kernel with the stats epilogue) at the training shapes and
    at the ragged Nq != Nk of :func:`phase_train_kernels`: output equal to
    K6's bit for bit, m and l within 1e-5 relative, 2 bf16 ulps against the
    plain version, and the precision gate; K7 on fp32 operands (the tf32
    kernel's STATS form) at ds1 and the ragged Nq != Nk: output equal to K8's
    bit for bit, m and l within 1e-5 relative, out within 1e-5 of its peak.
    K8 at fp32 (1, 4096, 320) and at the 1024^2 ds1 site (1, 16384, 320), on
    the tf32 kernel, within 1e-5 of the output's peak (three tf32 terms per
    product and another summation order), and at bf16 (1, 4096, 320), on K6's
    kernel, within 2 ulps of K6's plain version (the same function) and equal
    to K6's output bit for bit (:func:`equal_k6`). K9 at the
    ds4 feed-forward, (3072, 1280) with I = 5120, within 2 bf16 ulps at the
    output's peak against K2's plain version (K9 computes K2's function).

    Bounds: bf16 operands' attention (K7, K8) at the bf16 tensor-core peak;
    fp32 operands' (K7, K8) at the 3xTF32 line (:func:`tf32x3_bound`: the
    products at 165 TFLOP/s, the bytes or the exponentials), with the CUDA
    cores' FFMA line beside it (``fp32_ffma_ms``); K9's 6*M*C*I at the bf16
    peak, or each one's bytes. Library: SDPA on fp32 inputs (K7, K8), the
    unfused route (K9). K9 also at the middle block's M = 768."""
    import torch
    import torch.nn.functional as F

    import vface_torch.ops as O
    from vface_torch.ops import flash_attention as FA
    from vface_torch.ops import geglu_ff as FF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s, dtype=torch.bfloat16, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(dtype)
    rows = {"flash_attention_v2_stats": [], "flash_attention_v1": [], "geglu_ff_wide": []}
    for nq, nk, c in ((4096, 4096, 320), (1024, 1024, 640), (RAGGED_NQ, RAGGED_NK, 320)):
        h, b = 8, 1
        dh = c // h
        q, k, v = randn(b, nq, c), randn(b, nk, c), randn(b, nk, c)
        shape = _shape(b, nq, nk, c, h)
        out, m, l = FA.flash_attention_v2_stats(q, k, v, h)
        want, wm, wl = FA.flash_attention_v2_stats_ref(q, k, v, h)
        torch.cuda.synchronize()
        rel_ml = max(((m - wm).abs() / wm.abs().clamp(min=1e-30)).max().item(), ((l - wl).abs() / wl).max().item())
        bitwise = torch.equal(out, FA.flash_attention_fp32(q, k, v, h))
        log("kernel_v2_stats_check", shape=shape, m_l_max_rel_err=f"{rel_ml:.3e}", tol="1e-05", equals_k6=bitwise)
        if not (rel_ml <= 1e-5 and bitwise):
            raise SystemExit("chip_smoke: flash_attention_v2_stats's m/l disagree or its output is not K6's")
        precision_gate("flash_attention_v2_stats", shape, out, want, FA.flash_attention_stats_ref(q, k, v, h)[0])
        split = lambda t: t.view(b, -1, h, dh).transpose(1, 2).float()
        qf, kf, vf = split(q), split(k), split(v)
        rows["flash_attention_v2_stats"].append(_row(
            "flash_attention_v2_stats", "cuda", "vface_torch/csrc/flash_attention.cu",
            "vface_tpu/ops/pallas_attention.py:302", _errs(out, want),
            ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
            cuda_ms(lambda: FA.flash_attention_v2_stats(q, k, v, h)),
            cuda_ms(lambda: FA.flash_attention_v2_stats_ref(q, k, v, h), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf)),
            bound(4.0 * b * h * nq * nk * dh, (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * h * nq * 4), shape))
        del qf, kf, vf

    for nq, nk in ((4096, 4096), (RAGGED_NQ, RAGGED_NK)):  # K7 on fp32 operands: the tf32 kernel
        h, b, c = 8, 1, 320
        dh = c // h
        q, k, v = (randn(b, n, c, dtype=torch.float32) for n in (nq, nk, nk))
        shape = _shape(b, nq, nk, c, h) + " fp32"
        out, m, l = FA.flash_attention_v2_stats(q, k, v, h)
        want, wm, wl = FA.flash_attention_v2_stats_ref(q, k, v, h)
        torch.cuda.synchronize()
        rel_ml = max(((m - wm).abs() / wm.abs().clamp(min=1e-30)).max().item(), ((l - wl).abs() / wl).max().item())
        bitwise = torch.equal(out, FA._flash_attention_v1(q, k, v, h))
        log("kernel_v2_stats_check", shape=shape, m_l_max_rel_err=f"{rel_ml:.3e}", tol="1e-05", equals_k8=bitwise)
        if not (rel_ml <= 1e-5 and bitwise):
            raise SystemExit("chip_smoke: fp32 flash_attention_v2_stats's m/l disagree or its output is not K8's")
        split = lambda t: t.view(b, -1, h, dh).transpose(1, 2)
        flops = 4.0 * b * h * nq * nk * dh
        rows["flash_attention_v2_stats"].append(_row(
            "flash_attention_v2_stats", "cuda", "vface_torch/csrc/flash_attention_f32.cu",
            "vface_tpu/ops/pallas_attention.py:302", _errs(out, want), ("rel", 1e-5),
            cuda_ms(lambda: FA.flash_attention_v2_stats(q, k, v, h)),
            cuda_ms(lambda: FA.flash_attention_v2_stats_ref(q, k, v, h), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))),
            tf32x3_bound(flops, (2 * q.numel() + 2 * k.numel()) * 4 + 2 * b * h * nq * 4, b * h * nq * nk), shape,
            ffma=ffma_ms(flops)))
        del q, k, v, out, m, l, want, wm, wl

    for n, dtype in ((4096, torch.float32), (16384, torch.float32), (4096, torch.bfloat16)):
        h, b, c = 8, 1, 320
        dh = c // h
        q, k, v = randn(b, n, c, dtype=dtype), randn(b, n, c, dtype=dtype), randn(b, n, c, dtype=dtype)
        shape = f"({b},{n},{c})h{h}{'' if dtype == torch.float32 else ' bf16'}"
        got = O.flash_attention_v1(q, k, v, h)
        fast = n > 4096  # one timed launch of the slow plain version at N = 16384
        if dtype == torch.float32:
            plain = lambda: FA.flash_attention_v1_ref(q, k, v, h)
            want = plain()
            tol = ("rel", 1e-5)
        else:  # bf16 operands: K6's function, held to K6's plain version
            plain = lambda: FA.flash_attention_fp32_ref(q, k, v, h)
            want = plain()
            tol = ("abs", 2 * bf16_ulp(want.float().abs().max().item()))
            equal_k6(got, FA.flash_attention_fp32(q, k, v, h), "flash_attention_v1", shape)
        torch.cuda.synchronize()
        split = lambda t: t.view(b, n, h, dh).transpose(1, 2).float()
        qf, kf, vf = split(q), split(k), split(v)
        flops, nbytes = 4.0 * b * h * n * n * dh, 4 * q.numel() * q.element_size()
        f32 = dtype == torch.float32
        rows["flash_attention_v1"].append(_row(
            "flash_attention_v1", "cuda", f"vface_torch/csrc/{'flash_attention_f32.cu' if f32 else 'flash_attention.cu'}",
            "vface_tpu/ops/pallas_attention.py:44", _errs(got, want), tol,
            cuda_ms(lambda: O.flash_attention_v1(q, k, v, h), reps=3 if fast else 10),
            cuda_ms(plain, reps=1 if fast else 3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf), reps=3 if fast else 10),
            tf32x3_bound(flops, nbytes, b * h * n * n) if f32 else bound(flops, nbytes), shape,
            ffma=ffma_ms(flops) if f32 else None))
        del q, k, v, qf, kf, vf, got, want

    c = 1280  # ds4 at the sampling batch (2 chunks x 6 frames x 16^2 tokens) and the middle block (8^2)
    inner = 4 * c
    for m in (12 * 256, 12 * 64):
        args = (randn(m, c), randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1),
                randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1))
        got = O.geglu_ff_wide(*args)
        want = FF.geglu_ff_ref(*args)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: O.geglu_ff_wide(*args))
        unfused_ms = cuda_ms(lambda: FF.geglu_ff_unfused(*args))
        rows["geglu_ff_wide"].append(_row(
            "geglu_ff_wide", "cuda", "vface_torch/csrc/geglu_ff.cu", "vface_tpu/ops/pallas_ff.py:120",
            _errs(got, want), ("abs", 2 * bf16_ulp(want.float().abs().max().item())), ms,
            cuda_ms(lambda: FF.geglu_ff_ref(*args), reps=3, warmup=1), unfused_ms,
            _ff_bound(m, c, inner), f"({m},{c})I{inner}"))
        log("ff_route", site=f"({m},{c})I{inner}", k9_ms=f"{ms:.4f}", unfused_ms=f"{unfused_ms:.4f}",
            faster="k9" if ms < unfused_ms else "unfused",
            note="the UNet takes K9 at its wide sites without a gradient, the unfused route with one")
        del args, got, want
    return rows


def phase_bench_kernels() -> dict:
    """K10-K13 against their plain versions at the benches' shapes; returns the rows.

    K10 (v3) and K11 (v4), on K6's kernel, and K12 (v6), on K1's, at the
    attention bench's ds1 and ds2 shapes (b 12, N 4096 and 1024, h 8, dh 40,
    bf16), JAX's default 1024-key blocks: 2 bf16 ulps at the output's peak
    against ``flash_attention_v1_ref`` over those blocks (K10, K11; both also
    equal to K6's output bit for bit, :func:`equal_k6`) and K1's plain
    version (K12); all three on fp32 operands (the tf32 kernel) at
    (12, 1024, 320), within 1e-5 of the output's peak against
    ``flash_attention_v1_ref``. K13 at the row-tile sweep's shapes (C 320
    with M = 24*4096, C 640 with M = 24*1024, the bench's operands), each
    built tile: 2 ulps against K2's plain version.

    Bounds at the bf16 tensor-core peak (bf16 operands: the tensor cores
    compute K8's function as K6 does) or the bytes; fp32 operands at the
    3xTF32 line with the FFMA line beside it. Library: SDPA on the fp32-cast
    inputs (K10, K11), SDPA (K12; fp32 SDPA at fp32), the unfused route (K13)."""
    import torch
    import torch.nn.functional as F

    from vface_torch.bench import attention as BA, ff_tile as BF
    from vface_torch.ops import _archive_attention as AA
    from vface_torch.ops import flash_attention as FA
    from vface_torch.ops import geglu_ff as FF

    rows = {name: [] for name in BENCH_KERNELS}
    line = {"flash_attention_v3": 72, "flash_attention_v4": 158, "flash_attention_v6": 247}
    h, dh = BA.H, BA.DH
    with torch.inference_mode():
        for _, b, n in BA.CASES:
            q, k, v = (BA.randn((b, n, h * dh), seed=s) for s in range(3))
            shape = f"({b},{n},{h * dh})h{h} bf16"
            split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
            blk = min(1024, n)
            bnd = bound(4.0 * b * h * n * n * dh, 4 * q.numel() * 2)
            for name in ("flash_attention_v3", "flash_attention_v4", "flash_attention_v6"):
                fn = getattr(AA, name)
                if name == "flash_attention_v6":
                    plain = lambda: FA.flash_attention_ref(q, k, v, h)
                    lib = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))
                else:
                    plain = lambda: FA.flash_attention_v1_ref(q, k, v, h, block_k=blk)
                    lib = lambda: F.scaled_dot_product_attention(split(q).float(), split(k).float(),
                                                                 split(v).float())
                got, want = fn(q, k, v, h, blk, blk), plain()
                if name != "flash_attention_v6":
                    equal_k6(got, FA.flash_attention_fp32(q, k, v, h), name, shape)
                torch.cuda.synchronize()
                rows[name].append(_row(
                    name, "cuda", "vface_torch/csrc/flash_attention.cu", f"vface_tpu/ops/_archive_attention.py:{line[name]}",
                    _errs(got, want), ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
                    cuda_ms(lambda: fn(q, k, v, h, blk, blk)), cuda_ms(plain, reps=2, warmup=1), cuda_ms(lib),
                    bnd, shape, exp_floor(b * h * n * n) if name == "flash_attention_v6" else None))
                del got, want
            del q, k, v
        b, n = 12, 1024  # fp32 operands, all three on the tf32 kernel (v6's P rounding is a no-op at fp32)
        q, k, v = (BA.randn((b, n, h * dh), seed=s, dtype=torch.float32) for s in range(3))
        shape = f"({b},{n},{h * dh})h{h} fp32"
        split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
        flops = 4.0 * b * h * n * n * dh
        bnd = tf32x3_bound(flops, 4 * q.numel() * 4, b * h * n * n)
        plain = lambda: FA.flash_attention_v1_ref(q, k, v, h, block_k=n)
        want = plain()
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)))
        for name in ("flash_attention_v3", "flash_attention_v4", "flash_attention_v6"):
            fn = getattr(AA, name)
            got = fn(q, k, v, h, n, n)
            torch.cuda.synchronize()
            rows[name].append(_row(
                name, "cuda", "vface_torch/csrc/flash_attention_f32.cu",
                f"vface_tpu/ops/_archive_attention.py:{line[name]}", _errs(got, want), ("rel", 1e-5),
                cuda_ms(lambda: fn(q, k, v, h, n, n)), plain_ms, lib_ms, bnd, shape, ffma=ffma_ms(flops)))
            del got
        del q, k, v, want
        for c, m in BF.CASES:
            args = BF.operands(c, m)
            want = FF.geglu_ff_ref(*args)
            plain_ms = cuda_ms(lambda: FF.geglu_ff_ref(*args), reps=2, warmup=1)
            unfused_ms = cuda_ms(lambda: FF.geglu_ff_unfused(*args))
            for tm in FF.SPLIT_TILES[c]:
                got = FF.geglu_ff_split(*args, tm)
                torch.cuda.synchronize()
                rows["geglu_ff_split"].append(_row(
                    "geglu_ff_split", "cuda", "vface_torch/csrc/geglu_ff.cu", "scripts/bench_ff_tile.py:63",
                    _errs(got, want), ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
                    cuda_ms(lambda: FF.geglu_ff_split(*args, tm)), plain_ms, unfused_ms,
                    _ff_bound(m, c, 4 * c), f"({m},{c})I{4 * c} tm{tm}"))
            del args, want, got
    torch.cuda.empty_cache()
    return rows


def phase_bench(reps: int) -> dict:
    """The kernel-bench path, K10-K13's main path: ``python -m
    vface_torch.bench.attention``, ``.attn_v56`` and ``.ff_tile`` in process at
    their own shapes with ``reps`` timed calls per variant, counters reset
    first; returns the launches."""
    import torch

    from vface_torch.bench import attention, attn_v56, ff_tile

    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    attention.main(["--reps", str(reps)])
    attn_v56.main(["--reps", str(reps)])
    ff_tile.main(["--reps", str(reps)])
    launches = kernel_counts()
    log("bench", reps=reps, wall_s=f"{time.perf_counter() - t0:.1f}",
        **{k: launches[k] for k in BENCH_KERNELS})
    missing = [k for k in BENCH_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the bench path launched no {missing} kernel")
    torch.cuda.empty_cache()
    return launches


VIDEO_FRAMES, VIDEO_HW = 8, (720, 1280)  # an HD clip: a 6-frame window and a 2-frame window


def synthetic_clip(frames: int, hw, seed: int, device="cuda"):
    """A seeded, smoothly moving cartoon face over a smooth background, (F, H, W, 3) in [0, 1]:
    skin, hair, eyes and a mouth drift a few pixels and turn slightly per frame."""
    import torch

    h, w = hw
    g = torch.Generator(device=device).manual_seed(seed)
    bg = torch.nn.functional.interpolate(torch.rand((1, 3, 9, 16), generator=g, device=device), size=(h, w),
                                         mode="bilinear").permute(0, 2, 3, 1)[0] * 0.6 + 0.2
    skin = torch.rand(3, generator=g, device=device) * 0.3 + torch.tensor([0.6, 0.45, 0.35], device=device)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    out = []
    for i in range(frames):
        cx, cy, r = w * 0.5 + 6.0 * i, h * 0.5 + 2.0 * i, h * 0.28 * (1 + 0.01 * i)
        ang = 0.02 * i
        u = ((xx - cx) * math.cos(ang) + (yy - cy) * math.sin(ang)) / r
        v = (-(xx - cx) * math.sin(ang) + (yy - cy) * math.cos(ang)) / r
        img = bg.clone()
        blobs = [((0.0, -0.55, 0.85, 0.55), torch.tensor([0.15, 0.1, 0.08], device=device)),  # hair
                 ((0.0, 0.0, 0.72, 0.95), skin),  # face
                 ((-0.3, -0.22, 0.12, 0.06), torch.tensor([0.1, 0.1, 0.12], device=device)),  # eyes
                 ((0.3, -0.22, 0.12, 0.06), torch.tensor([0.1, 0.1, 0.12], device=device)),
                 ((0.0, 0.12, 0.06, 0.12), skin * 0.8),  # nose
                 ((0.0, 0.45, 0.25, 0.07), torch.tensor([0.6, 0.2, 0.2], device=device))]  # mouth
        for (ex, ey, rx, ry), col in blobs:
            q = ((u - ex) / rx) ** 2 + ((v - ey) / ry) ** 2
            a = torch.clamp((1.0 - q) / 0.15, 0.0, 1.0)[..., None]
            img = img + a * (col - img)
        out.append(img)
    return torch.stack(out).clamp(0.0, 1.0)


def phase_video(model, seed: int) -> dict:
    """The slice at full width: ``swap_video_frames`` on a seeded 8-frame
    720x1280 clip at the reference operating point (50 + 50 steps, window 6,
    RAFT 20 iterations, parser 512), after a 2 + 2-step warm-up that holds
    every kernel call site to its plain version at the measured call's shapes
    (both windows' batches; the background trick's and the landmark net's
    GroupNorms); returns the kernels' launches over the measured call."""
    import torch

    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import init_aux_params

    opts = SwapOptions(ddim_steps=DDIM_STEPS, inversion_steps=INVERSION_STEPS, window=FRAMES,
                       image_size=model.cfg.image_size, parser_size=512, raft_iters=20)
    aux = init_aux_params(torch.Generator(device="cuda").manual_seed(seed))
    pipe = VideoSwapPipeline(model, opts, device="cuda", aux_params=aux)
    frames = synthetic_clip(VIDEO_FRAMES, VIDEO_HW, seed)
    source = synthetic_clip(1, VIDEO_HW, seed + 1)[0]
    t0 = time.perf_counter()
    short = VideoSwapPipeline(model, dataclasses.replace(opts, ddim_steps=2, inversion_steps=2), device="cuda",
                              aux_params=aux)
    with checked_sites("video"):
        short.swap_video_frames(frames, source)
    torch.cuda.synchronize()
    log("video_warmup", ddim_steps=2, inversion_steps=2, wall_s=f"{time.perf_counter() - t0:.3f}")
    del short
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    out = pipe.swap_video_frames(frames, source, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    windows = sum(timings.get(k, 0.0) for k in ("encode", "invert", "sample", "decode"))
    log("video", frames=VIDEO_FRAMES, frame_hw=f"{VIDEO_HW[0]}x{VIDEO_HW[1]}", window=FRAMES,
        ddim_steps=DDIM_STEPS, inversion_steps=INVERSION_STEPS, raft_iters=opts.raft_iters,
        parser=opts.parser_size, wall_s=f"{wall:.3f}", frames_per_s=f"{VIDEO_FRAMES / wall:.4f}",
        windows_s=f"{windows:.3f}", **{f"{k}_s": f"{v:.3f}" for k, v in timings.items()},
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", fallback_frames=pipe.fallback_frames)
    log("video_launches", **{k: v for k, v in launches.items() if v})
    finite = bool(torch.isfinite(out).all())
    log("video_check", shape=tuple(out.shape), dtype=out.dtype, finite=finite, min=f"{float(out.min()):.4f}",
        max=f"{float(out.max()):.4f}", mean_abs_change=f"{float((out - frames.cpu()).abs().mean()):.4f}")
    if not (tuple(out.shape) == (VIDEO_FRAMES, *VIDEO_HW, 3) and finite
            and float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
        raise SystemExit("chip_smoke: the video output has the wrong shape, is not finite or leaves [0, 1]")
    missing = [k for k in SWAP_KERNELS if launches[k] == 0]
    stray = [k for k in launches if k not in SWAP_KERNELS and launches[k]]
    if missing or stray:
        raise SystemExit(f"chip_smoke: the video path launched no {missing} / stray {stray} kernels")
    return launches


def phase_small_video_reference(seed: int) -> None:
    """The tiny fp32 ``swap_video_frames`` (4 frames of 48 x 64, window 3, RAFT
    2 iterations, parser 64; the tests hold the CPU's to the JAX package) on
    the card against the same call on the CPU, same weights and inputs:
    landmarks within 1e-3 px, flow within 1e-3 px (from the same crops),
    class maps equal on >= 99.9 % of pixels, and the frames within 1e-4 with
    the keep-masks and the frames' landmarks taken from the CPU's run (so
    that neither a parser tie nor the landmark stage's own round-off, which
    the stage checks hold, decides the result: a 1e-5 px move of the
    landmarks moves this random-weight pipeline's output by ~9e-5 through
    the crops, measured on the CPU). The frames with each device's own
    landmarks are reported beside it."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.preprocess.masks import inpaint_inputs
    from vface_torch.utils.convert import init_aux_params, init_params

    cfg = ModelConfig.tiny(image_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(seed), conditioner=True)
    aux = init_aux_params(torch.Generator().manual_seed(seed + 1))
    opts = SwapOptions(ddim_steps=2, inversion_steps=2, window=3, image_size=32, parser_size=64, raft_iters=2,
                       flow_tokens=256)
    frames = synthetic_clip(4, (48, 64), seed + 2, device="cpu")
    source = synthetic_clip(1, (48, 64), seed + 3, device="cpu")[0]
    res = {}
    for dev in ("cpu", "cuda"):
        model = VFaceModel(cfg, device=dev, conditioner=True)
        model.load_params(params)
        pipe = VideoSwapPipeline(model, opts, device=dev, aux_params=aux)
        r = {"landmarks": pipe.detect_landmarks(frames).cpu()}
        if dev == "cpu":
            res["landmarks"] = r["landmarks"]
            crops = pipe.align_crops(frames)[0]
            src_crop = pipe.align_crops(source[None])[0]
            res["crops"] = crops
            keep = inpaint_inputs(crops * 2 - 1, pipe.parse_masks(crops))[1]
            src_keep = inpaint_inputs(src_crop * 2 - 1, pipe.parse_masks(src_crop))[1][0]
            res["keep"] = (keep, src_keep)
        r["seg"] = pipe.parse_masks(res["crops"]).cpu()
        r["flow"] = pipe.compute_flow(res["crops"][:3]).cpu()
        keeps = dict(frame_keep=res["keep"][0], source_keep=res["keep"][1])
        r["out"] = pipe.swap_video_frames(frames, source, frame_landmarks=res["landmarks"], **keeps)
        r["out_own_landmarks"] = pipe.swap_video_frames(frames, source, **keeps)
        res[dev] = r
    c, g = res["cpu"], res["cuda"]
    err = {k: float((g[k] - c[k]).abs().max()) for k in ("landmarks", "flow", "out", "out_own_landmarks")}
    seg_eq = float((g["seg"] == c["seg"]).float().mean())
    log("small_video_reference", config="tiny fp32, 4 frames 48x64, window 3, 2 + 2 steps, RAFT 2, parser 64",
        landmarks_max_px=f"{err['landmarks']:.3e}", flow_max_px=f"{err['flow']:.3e}", class_map_equal=f"{seg_eq:.5f}",
        frames_max_abs_err=f"{err['out']:.3e}", tol="lm 1e-3, flow 1e-3, seg 0.999, frames 1e-4",
        frames_own_landmarks_max_abs_err=f"{err['out_own_landmarks']:.3e}")
    if not (err["landmarks"] <= 1e-3 and err["flow"] <= 1e-3 and seg_eq >= 0.999 and err["out"] <= 1e-4):
        raise SystemExit("chip_smoke: the card's tiny video swap disagrees with the CPU's")


FUSION_MODES = ("replace", "temporal", "adain", "mix", "fft_vfixed")


def phase_ops(model, frames: int, seed: int) -> dict:
    """The ``vface_torch.ops`` entry points at full width; returns the launches.

    flash_attention_v2 forward and backward with autograd at the training
    shapes (bf16, batch 1), gradients against the plain path (2 ulps and the
    precision gate); ``flash_attention``'s gradient at a ragged Nq != Nk
    against the plain path (2 ulps); flash_attention_v1 at the N = 16384 fp32 site and the
    port's flash_attention on fp32 operands (K8); geglu_ff_wide at ds4 with the
    serving model's weights, against the unfused route; and one UNet eval on
    the 3-chunk window batch (b = 18 at the 64^2 latent, bf16, kernels on) per
    fusion mode, finite and within 3e-2 relative L2 of the plain path."""
    import torch

    import vface_torch.ops as O
    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops import flash_attention as FA
    from vface_torch.ops import geglu_ff as FF
    from vface_torch.ops.warp import resize_flow

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device=dev).to(dtype)
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    reset_counts()

    for n, c in ((4096, 320), (1024, 640)):
        h = 8
        shape = f"(1,{n},{c})h{h}"
        leaves = [randn(1, n, c).requires_grad_(True) for _ in range(3)]
        do = randn(1, n, c)
        out = O.flash_attention_v2(*leaves, h)
        out.backward(do)
        got = [x.grad for x in leaves]
        q, k, v = (x.detach() for x in leaves)
        want_out, m, l = FA.flash_attention_v2_stats_ref(q, k, v, h)
        dd = FA.rowsum_do_o(do, FA.flash_attention_fp32_ref(q, k, v, h), h)
        want = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h)
        yard = FA.flash_attention_bwd_ref(q, k, v, do, m, l, dd, h, round_p=True)
        torch.cuda.synchronize()
        ratios = [_errs(gi, wi)[0] / (2 * bf16_ulp(wi.float().abs().max().item())) for gi, wi in zip(got, want)]
        log("ops_v2_grad", shape=shape, out_err_over_tol=f"{_errs(out, want_out)[0] / (2 * bf16_ulp(want_out.float().abs().max().item())):.3f}",
            dq_dk_dv_err_over_tol=",".join(f"{r:.3f}" for r in ratios))
        if not max(ratios) <= 1.0:
            raise SystemExit("chip_smoke: flash_attention_v2's gradients disagree with the plain path")
        for gname, gi, wi, yi in zip(("dq", "dk", "dv"), got, want, yard):
            precision_gate(f"flash_attention_v2.{gname}", shape, gi, wi, yi)
        del leaves, out, got, want, yard

    # the UNet's entry point with a gradient at Nq != Nk (K4, then K6 and K5)
    # against the same autograd graph through the plain versions
    h = 8
    q, do = randn(1, RAGGED_NQ, 320), randn(1, RAGGED_NQ, 320)
    k, v = randn(1, RAGGED_NK, 320), randn(1, RAGGED_NK, 320)
    grads = {}
    for name, fn in (("kernels", FA.flash_attention), ("plain", FA.flash_attention_ref)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, h).backward(do)
        grads[name] = [x.grad for x in leaves]
    torch.cuda.synchronize()
    ratios = [_errs(gi, wi)[0] / (2 * bf16_ulp(wi.float().abs().max().item()))
              for gi, wi in zip(grads["kernels"], grads["plain"])]
    log("ops_cross_grad", shape=_shape(1, RAGGED_NQ, RAGGED_NK, 320, h),
        dq_dk_dv_err_over_tol=",".join(f"{r:.3f}" for r in ratios))
    if not max(ratios) <= 1.0:
        raise SystemExit("chip_smoke: flash_attention's gradients at Nq != Nk disagree with the plain path")
    del q, k, v, do, grads

    q = randn(1, 16384, 320, dtype=torch.float32)
    out = O.flash_attention_v1(q, q, q, 8)
    want = FA.flash_attention_v1_ref(q, q, q, 8)
    q4 = randn(1, 4096, 320, dtype=torch.float32)
    with torch.inference_mode():
        out4 = FA.flash_attention(q4, q4, q4, 8)  # the UNet's entry point on fp32 operands
    want4 = FA.flash_attention_ref(q4, q4, q4, 8)
    torch.cuda.synchronize()
    e1, e4 = _errs(out, want)[1], _errs(out4, want4)[1]
    log("ops_v1", site="(1,16384,320)h8 fp32", max_rel_err=f"{e1:.3e}", fp32_flash_attention_max_rel_err=f"{e4:.3e}",
        tol="1e-05")
    if not (e1 <= 1e-5 and e4 <= 1e-5):
        raise SystemExit("chip_smoke: K8 on the ops path disagrees with its plain version")
    del q, out, want, q4, out4, want4

    ff = model.unet.in_2_0_attn.block_0.ff  # a ds4 feed-forward, C = 1280
    dt = torch.bfloat16
    x = randn(2 * frames * 256, ff.proj_out.weight.shape[0])
    w = (ff.geglu.proj.weight.to(dt), ff.geglu.proj.bias.to(dt), ff.proj_out.weight.to(dt), ff.proj_out.bias.to(dt))
    with torch.inference_mode():
        wide, unfused = O.geglu_ff_wide(x, *w), FF.geglu_ff_unfused(x, *w)
    torch.cuda.synchronize()
    e_ff = rel(wide, unfused)
    log("ops_ff_wide", site=f"ds4 {tuple(x.shape)}", rel_l2_vs_unfused=f"{e_ff:.3e}", tol=3e-2)
    if not e_ff <= 3e-2:
        raise SystemExit("chip_smoke: K9 disagrees with the unfused route at ds4")

    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    hl, d = model.cfg.latent_size, model.cfg.unet.context_dim
    b = 3 * frames
    x9 = torch.randn((b, hl, hl, 9), generator=g, device="cuda")
    ts = torch.full((b,), 961, device="cuda")
    ctx = torch.randn((b, 1, d), generator=g, device="cuda")
    flow = resize_flow(window_inputs(model, frames, seed)["flow"], hl, hl)
    for mode in FUSION_MODES:
        inj = InjectionSpec(input_blocks=O.FusionConfig(mode), chunks=3)
        run = lambda: model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
        with torch.inference_mode():
            eps_k = run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eps_k = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            with plain_kernels():
                eps_p = run()
        err = rel(eps_k, eps_p)
        finite = bool(torch.isfinite(eps_k).all())
        log("ops_unet", mode=mode, batch=b, ms_per_eval=f"{ms:.1f}", eps_rel_l2_vs_plain=f"{err:.3e}", tol=3e-2,
            finite=finite)
        if not (finite and err <= 3e-2):
            raise SystemExit(f"chip_smoke: the full-width UNet in fusion mode {mode} disagrees with its plain path")
    launches = kernel_counts()
    log("ops_launches", **launches)
    missing = [k for k in OPS_KERNELS if launches[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: the ops path launched no {missing} kernel")
    return launches


# the fp32 UNet's kernels: without a gradient (the attention on K8's tf32
# kernel), and with one (its 64^2 latents take no GroupNorm kernel: K3 serves
# the VAE's 128^2-512^2 stages)
F32_EVAL_KERNELS = ("flash_attention_v1", "geglu_ff_f32", "geglu_ff_wide_f32")
F32_TRAIN_KERNELS = ("flash_attention_stats_f32", "flash_attention_fp32_f32", "flash_attention_bwd_dq_f32",
                     "flash_attention_bwd_dkv_f32", "geglu_ff_f32")


def phase_fp32_unet(smi: str, frames: int, seed: int) -> dict:
    """The SD-v1 UNet at fp32 (``ModelConfig.sd_v1_inpaint(dtype=float32)``:
    use_flash, use_fused_ff, remat) at full width with seeded weights: one
    eval without a gradient at the sampling batch (2 chunks x the window, 64^2
    latents) and one loss (MSE of epsilon against a seeded target) + backward
    at batch 1, counters reset before each; each held to the same call under
    :func:`plain_kernels` in relative L2 (epsilon; all UNet parameters'
    gradients together). Returns the launches of both runs."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig.sd_v1_inpaint(dtype=torch.float32)
    model = VFaceModel(cfg, device="cuda")
    model.load_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(seed)))
    unet = model.unet
    del model.vae
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    hl, d, b = cfg.latent_size, cfg.unet.context_dim, 2 * frames
    x9 = torch.randn((b, hl, hl, 9), generator=g, device="cuda")
    ts = torch.full((b,), 961, device="cuda")
    ctx = torch.randn((b, 1, d), generator=g, device="cuda")
    target = torch.randn((1, hl, hl, 4), generator=g, device="cuda")
    rel = lambda a, w: float((a - w).norm() / w.norm())

    def loss_grads():
        unet.zero_grad(set_to_none=True)
        loss = ((unet(x9[:1], ts[:1], ctx[:1]) - target) ** 2).mean()
        loss.backward()
        return float(loss), [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                             for p in unet.parameters()]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        eps_k = unet(x9, ts, ctx)
    torch.cuda.synchronize()
    eval_s, eval_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    eval_launches = kernel_counts()
    with torch.inference_mode(), plain_kernels():
        eps_p = unet(x9, ts, ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss_k, grads_k = loss_grads()
    torch.cuda.synchronize()
    train_s, train_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    train_launches = kernel_counts()
    with plain_kernels():
        loss_p, grads_p = loss_grads()
    unet.zero_grad(set_to_none=True)
    e_eps = rel(eps_k, eps_p)
    e_grad = math.sqrt(sum(float((a - w).norm()) ** 2 for a, w in zip(grads_k, grads_p))) / math.sqrt(
        sum(float(w.norm()) ** 2 for w in grads_p))
    finite = bool(torch.isfinite(eps_k).all()) and all(bool(torch.isfinite(a).all()) for a in grads_k)
    # each fp32 kernel is within ~1e-6 of its plain version (three tf32 terms
    # per product, other summation orders); ~70 random-weight layers carry the
    # bf16 path's 2^-9 roundings to ~1e-2, so these to ~1e-5. 1e-3 leaves that
    # margin, while one tf32 term per product (~2^-11 relative each) would not
    tol = 1e-3
    log("fp32_unet", config="sd_v1_inpaint fp32 (use_flash, use_fused_ff, remat)", card=smi.replace(" ", "_"),
        eval_batch=b, latent=f"{hl}^2", eval_s=f"{eval_s:.3f}", eval_peak_gib=f"{eval_peak:.2f}",
        eps_rel_l2_vs_plain=f"{e_eps:.3e}", train_batch=1, train_s=f"{train_s:.3f}",
        train_peak_gib=f"{train_peak:.2f}", loss_kernels=f"{loss_k:.7f}", loss_plain=f"{loss_p:.7f}",
        grad_rel_l2_vs_plain=f"{e_grad:.3e}", tol=tol, finite=finite)
    log("fp32_unet_launches", run="eval", **{k: v for k, v in eval_launches.items() if v})
    log("fp32_unet_launches", run="loss_backward", **{k: v for k, v in train_launches.items() if v})
    del unet, model, eps_k, eps_p, grads_k, grads_p
    torch.cuda.empty_cache()
    if not (finite and e_eps <= tol and e_grad <= tol):
        raise SystemExit("chip_smoke: the fp32 UNet's kernel path disagrees with its plain path")
    for run, launched, wanted in (("eval", eval_launches, F32_EVAL_KERNELS),
                                  ("loss_backward", train_launches, F32_TRAIN_KERNELS)):
        missing = [k for k in wanted if launched[k] == 0]
        stray = [k for k in launched if k not in wanted and launched[k]]
        if missing or stray:
            raise SystemExit(f"chip_smoke: the fp32 UNet's {run} launched no {missing} / stray {stray} kernels")
    return {k: eval_launches[k] + train_launches[k] for k in eval_launches}


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
    """CUDA time by kernel over one full-width train step (torch.profiler); the
    table at PATH holds every op and kernel, the log line the 25 largest."""
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
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=-1))  # every op and kernel
    log("profile_train", what="loss + backward, no optimizer step", wall_ms=f"{wall_ms:.1f}",
        device_ms=f"{total:.1f}", device_busy=f"{total / wall_ms:.3f}", table=path)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")


def kernels_line(rows: dict, launches: dict) -> dict:
    """One entry per kernel: the ds1 / largest site's numbers at top level, every site under "sites".

    ``launches`` is each kernel's count over its main path's run (K1-K3 and K9
    the swap window, K4-K6 the timed train steps, K7-K8 the ops phase, K10-K13
    the bench phase, the fp32 forms of K5, K2 and K9 the fp32 UNet's eval and
    loss + backward); K5's two kernels launch together, and its entries carry
    the dQ kernel's count."""
    out = []
    for name, sites in rows.items():
        head = dict(sites[0])
        head["max_abs_err"] = max(r["max_abs_err"] for r in sites)
        head["launches"] = launches[name.replace("_bwd", "_bwd_dq", 1)]
        head["sites"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
                         for r in sites]
        head.pop("shape")
        out.append(head)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", metavar="PATH", help="also profile one sampling UNet eval, table to PATH")
    ap.add_argument("--profile-train", metavar="PATH", help="also profile one train step, table to PATH")
    ap.add_argument("--bench-reps", type=int, default=3, help="timed calls per variant in the bench phase")
    ap.add_argument("--previous", metavar="PATH", help="an earlier run's output: show its kernel times beside")
    args = ap.parse_args()
    if args.previous:
        PREVIOUS.update(read_previous(args.previous))

    import torch

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build()
    rows = phase_kernels(batch=2 * FRAMES, vae_batch=FRAMES)
    rows.update(phase_train_kernels())
    rows.update(phase_f32_kernels())
    phase_k1_tiles()
    rows.update(phase_ops_kernels())
    rows.update(phase_bench_kernels())
    bench_launches = phase_bench(args.bench_reps)
    model = build_model(SEED)
    launches = phase_swap(model, FRAMES, DDIM_STEPS, INVERSION_STEPS, SEED)
    phase_reference(model, FRAMES, SEED)
    phase_small_reference(SEED)
    phase_small_video_reference(SEED)
    ops_launches = phase_ops(model, FRAMES, SEED)
    if args.profile:
        phase_profile(model, FRAMES, SEED, args.profile)
    del model  # serving's swap_window needs no conditioner; the video path and training do
    torch.cuda.empty_cache()
    f32_launches = phase_fp32_unet(smi, FRAMES, SEED)
    model = build_model(SEED, conditioner=True)
    phase_video(model, SEED)
    torch.cuda.empty_cache()
    train_launches = phase_train(model, SEED)
    phase_train_reference(model, SEED)
    if args.profile_train:
        phase_profile_train(model, SEED, args.profile_train)
    launches.update({k: v for k, v in train_launches.items() if k not in SWAP_KERNELS})
    launches.update({k: ops_launches[k] for k in OPS_KERNELS})
    launches.update({k: bench_launches[k] for k in BENCH_KERNELS})
    launches.update({k: f32_launches[k] for k in ("flash_attention_bwd_dq_f32", "geglu_ff_f32", "geglu_ff_wide_f32")})
    print(smi, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
