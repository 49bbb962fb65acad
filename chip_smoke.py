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
     720x1280 clip at the reference operating point but for the depth (10 +
     10 steps; window 6, RAFT 20 iterations, parser 512; phase swap runs
     50 + 50 on one window): seconds per stage, frames/s, peak
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
 10b. train_terms: one full-width step with every term the training CLI
     leaves off (LPIPS on seeded weights at 0.1, the VLB term at 1e-3, a
     seeded landmark head at 0.1; AdamW at lr 0, so the model stays as it
     was), then ``make_split_train_step`` from the same generator state, its
     UNet gradients within 1e-3 relative L2 of the fused step's; the tiny
     fp32 loss with every term (128^2), card against CPU within 1e-4;
 10c. vae_train: ``make_vae_train_step`` on the SD VAE (the model's seeded
     weights, copied) at 512^2, batch 1, a seeded PatchGAN from step 0 and
     LPIPS: 3 steps, ms per step, peak memory, K3's launches and its
     gradient path's passes;
 10d. train_cli: the training CLI (``vface_torch.scripts.train.main``) in
     process at full width on a synthetic CelebA-HQ-layout directory the
     script writes (6 renders of ``synthetic_faces.render_face`` at 512^2 with
     class maps): 4 steps (log_every 1, image_log_every 2, ckpt_every 4: one
     save, cut from two for time),
     then ``--resume`` for 2 (saving on exit only): ms per step (the first
     step and those after an image log or a save left out), peak memory, the
     loss terms, launches per step, checkpoint bytes and seconds per save,
     the files written; the
     disk a save needs (from the state's numel) against what the temporary
     directory has; frozen parameters as the seeded init made them, the
     resumed run's params bit for bit those of the first run's model at its
     exit (copied from the live model, not read from a checkpoint);
 10e. racecheck: K2's fused kernel's a*g barrier: copies of ``geglu_ff.cu``
     without it (and one warp's epilogue delayed) and with the delay alone,
     against the shipped kernel; ``compute-sanitizer --tool racecheck`` where
     the toolkit ships it;
 11. (``--profile PATH``, ``--profile-train PATH``) CUDA time by kernel of one
     sampling UNet eval (and the device time of its feed-forwards: K2's sites,
     the wide sites on K9, and the rest), of one train step;
 11b. sched (the window schedules of the video path; ``phase_sched_kernels``
     adds K1, K2 and K9 rows at b = 18 and 24 to the kernels phase): (b) on
     the video phase's model, a seeded 12-frame 720x1280 clip at the
     reference operating point but for the depth (25 + 25 steps, cut for
     time) through the sequential loop, pipelined packs,
     the super-pack, its streaming form (numpy frames), merged sampling and
     the cross-window carry (on the clip's first 8 frames, cut from 12 for
     time; after a 2 + 2-step warm-up of the new batches
     under the kernel-site checks): per run seconds, frames/s, stages, peak
     memory, launches, the uint8 difference from the sequential run, the
     carry run's first window within 1 level of it; (c) one sampling UNet
     eval at b = 12, 18, 24, 36, 48: ms, ms per row, peak memory; then,
     after training, (a) the exactness gate: the SD-v1 model at fp32 with its
     conditioner, 10 frames of 512 x 512 at window 3, 4 + 4 steps, every
     scheduler and ``batch_windows=2`` within 1e-3 of the sequential loop,
     and the packed run with its boundary masks forced to ones at least 10x
     past that limit;
 11c. opts (after sched (b) and (c), on the video phase's model and sched's
     clip, against its exact sequential run): a warm-up holds one cached
     sampling eval and one CFG inversion eval (b = 12) to the plain kernels;
     the sequential loop at ``encoder_interval`` 2 and 3, the super-pack with
     merged sampling at 2 and the loop at eta = 0.5 (sched's 25 + 25): seconds,
     frames/s, invert and sample seconds, K1/K2/K9 launches (the cached runs
     gated to fewer K1s than the exact run), peak memory, the uint8 difference
     (reported); then the tiny fp32 samplers with the cache, eta (an explicit
     noise stack), ``src_start`` and inversion CFG on the card against the CPU
     within 1e-4;
 11d. multiface: a seeded 720^2 two-face ``render_scene`` rolled over 12
     frames; the face detector (shipped weights) on the card against the CPU
     (boxes 0.5 px, scores 1e-4, every face found in every frame), then
     ``swap_video_frames_multiface`` at the reference operating point but for
     the depth (20 + 20 steps): seconds (per face), frames/s, peak memory,
     launches;
 11e. image (on the video phase's model; ``phase_image_kernels`` adds K1, K2
     and K9 rows at b = 8, the test bench's 4 pairs under CFG, to the kernels
     phase): a 2-step warm-up of ``swap_image_batch`` at b = 4 and of
     ``one_inference``'s ``swap_one`` at b = 1 on a 1024^2 frame holds every
     K1, K2, K9 and K3 call at the new signatures to its plain version; then
     ``swap_image_batch`` at 512^2, b = 4, 25 steps (cut from 50 for time),
     scale 3.0 (seconds per stage, peak memory, launches), ``plms_sample`` at
     25 steps (evals per step, seconds) and ``ddim_sample_guided`` at b = 1
     with ID scaling and the ID gradient through the VAE decoder and ArcFace,
     10 steps (seconds a step, peak memory, K3's forward launches and its
     VJP's passes, every gradient finite and non-zero); the tiny fp32 image
     path, the conv injection and each token mode on the card against the
     CPU within 1e-4 of each output's peak;
 12. cli: the video-swap CLI (``vface_torch.scripts.vface_video_swap.main``)
     at its defaults but for the depth (SD-v1 inpainting with its
     conditioner, seeded; 25 + 25 steps, cut for time; window 6, scale 3.0,
     fps 10) on inputs written with the port's
     writers to a temporary directory: pair A, a 12-frame 720x1280 Y4M with a
     WAV beside it; pair B, 3 frames with precomputed parse maps. A 2 + 2-step
     warm-up at ``--batch_windows 2`` holds every kernel call at the packed
     shapes to its plain version; run A (both pairs; outputs checked: AVI
     streams, Y4M, GIF, manifest, PNGs), run R (pair A's AVI deleted, its
     second window dropped from the manifest: pair B skipped, one window
     recomputed, within 1 uint8 level of run A) and run P (pair A packed
     into one 12-frame call) print frames/s, the sink's seconds, peak
     memory and launches;
 12b. image_cli: ``inference_test_bench.main`` on 4 synthetic 512^2 pairs
     (one batch; 4 PNGs) and ``one_inference.main`` on a 1024^2 target with
     ``--watermark`` (the payload read back), with ``--safety_params`` (a
     seeded ViT-L/14 checker whose thresholds flag everything: a black
     output) and in the folder mode (2 targets x 1 source, the JAX CLI's
     names), each at 25 steps: wall seconds and peak memory per run;
 13. the card line, the ``kernels`` JSON line, then the result line.

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
import re
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
def checked_sites(phase: str, expect=None):
    """Hold the models' K1, K2, K3 and K9 call sites to their plain versions on
    their own inputs, at every input signature the run gives them: the first
    call at each (kernel, shapes, dtype, heads) is compared by
    :func:`kernel_errs`, one ``kernel_site`` line each, and a disagreement
    fails, as does a kernel of ``expect`` (default: all four) that was never
    called. Yields {kernel: signatures checked}."""
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
    missing = [name for name in (expect or SWAP_KERNELS) if not seen[name]]
    if missing:
        raise SystemExit(f"chip_smoke: the {phase} path called no {missing} kernel")


def k1_rows(batch: int, randn) -> list:
    """K1 at the two self-attention sites it serves, ds1 (dh 40) and ds2 (dh 80),
    at ``batch``: its rows (the library column is SDPA)."""
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

    out = []
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
        out.append(_row("flash_attention", "cuda", "vface_torch/csrc/flash_attention.cu",
                        "vface_tpu/ops/pallas_attention.py:547", errs, tol, ms, plain_ms,
                        lib_ms, bnd, f"({batch},{n},{c})h{h}", exp_floor(batch * h * n * n)))
        del q, k, v
    return out


def ff_rows(name: str, batch: int, randn) -> list:
    """K2 (``geglu_ff``) at the ds1 and ds2 transformer feed-forwards, or K9
    (``geglu_ff_wide``) at ds4 and the middle block (C 1280, 16^2 and 8^2
    tokens), at ``batch``: their rows (the library column is the unfused route,
    two cuBLAS bf16 products). K9's log lines also say which of the two the
    UNet's wide sites should take."""
    from vface_torch.ops import geglu_ff as FF

    kernel, sites, replaces = {
        "geglu_ff": (FF.geglu_ff, ((4096, 320), (1024, 640)), "vface_tpu/ops/pallas_ff.py:70"),
        "geglu_ff_wide": (FF.geglu_ff_wide, ((256, 1280), (64, 1280)), "vface_tpu/ops/pallas_ff.py:120")}[name]
    out = []
    for n, c in sites:
        inner = 4 * c
        m = batch * n
        args = (randn(m, c), randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.1),
                randn(c, inner, scale=inner**-0.5), randn(c, scale=0.1))
        errs, tol = kernel_errs(name, args, kernel(*args))
        ms = cuda_ms(lambda: kernel(*args))
        unfused_ms = cuda_ms(lambda: FF.geglu_ff_unfused(*args))
        out.append(_row(name, "cuda", "vface_torch/csrc/geglu_ff.cu", replaces, errs, tol, ms,
                        cuda_ms(lambda: FF.geglu_ff_ref(*args), reps=3, warmup=1), unfused_ms,
                        _ff_bound(m, c, inner), f"({m},{c})I{inner}"))
        if name == "geglu_ff_wide":
            log("ff_route", site=f"({m},{c})I{inner}", k9_ms=f"{ms:.4f}", unfused_ms=f"{unfused_ms:.4f}",
                faster="k9" if ms < unfused_ms else "unfused",
                note="the UNet takes K9 at its wide sites without a gradient, the unfused route with one")
        del args
    return out


def phase_kernels(batch: int, vae_batch: int) -> dict:
    """Each kernel against its plain version at the swap path's shapes; returns the rows.

    K1 and K2 at the sampling batch (2 chunks x the window), K3 at the VAE's
    (the window). :func:`checked_sites` holds them at every other shape the
    swap and video paths give them.
    """
    import torch

    from vface_torch.ops import geglu_ff as FF
    from vface_torch.ops import gn_sums as GN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    rows = {"flash_attention": k1_rows(batch, randn), "geglu_ff": ff_rows("geglu_ff", batch, randn)}

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
            "geglu_ff_split": FF.SPLIT_LAUNCHES, "geglu_ff_split_f32": FF.SPLIT_F32_LAUNCHES,
            "geglu_ff_f32": FF.F32_LAUNCHES,
            "geglu_ff_wide_f32": FF.WIDE_F32_LAUNCHES, "gn_sums": GN.LAUNCHES}


def reset_counts() -> None:
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    for name in FA.LAUNCHES:
        FA.LAUNCHES[name] = 0
    FF.LAUNCHES = 0
    FF.WIDE_LAUNCHES = 0
    FF.SPLIT_LAUNCHES = 0
    FF.SPLIT_F32_LAUNCHES = 0
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

    rows["geglu_ff_wide"] = ff_rows("geglu_ff_wide", 2 * FRAMES, randn)  # ds4 and the middle block, sampling
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
    built tile: 2 ulps against K2's plain version; and K13 on fp32 operands
    (the bench's values at fp32; K2's fp32 two-kernel form at its 128-row
    tile) within 1e-5 of the output's peak.

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

    rows = {name: [] for name in BENCH_KERNELS + ("geglu_ff_split_f32",)}
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
            # K13 on fp32 operands (no bench run takes them): its launches are
            # the timed calls of this row, the comparison's call left out
            args = tuple(a.float() for a in BF.operands(c, m))
            want = FF.geglu_ff_ref(*args)
            plain_ms = cuda_ms(lambda: FF.geglu_ff_ref(*args), reps=2, warmup=1)
            unfused_ms = cuda_ms(lambda: FF.geglu_ff_unfused(*args))
            inner = 4 * c
            flops = 6.0 * m * c * inner
            got = FF.geglu_ff_split(*args, 128)
            torch.cuda.synchronize()
            FF.SPLIT_F32_LAUNCHES = 0
            ms = cuda_ms(lambda: FF.geglu_ff_split(*args, 128))
            row = _row("geglu_ff_split_f32", "cuda", "vface_torch/csrc/geglu_ff.cu", "scripts/bench_ff_tile.py:63",
                       _errs(got, want), ("rel", 1e-5), ms, plain_ms, unfused_ms,
                       bound(3.0 * flops, (2 * m * c + 3 * c * inner + 2 * inner + c) * 4, PEAK_TF32_FLOPS),
                       f"({m},{c})I{inner} tm128 fp32", ffma=ffma_ms(flops))
            row["launches"] = FF.SPLIT_F32_LAUNCHES
            rows["geglu_ff_split_f32"].append(row)
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
# the video phase's depth: cut from the reference's 50 + 50 steps for time,
# since phase swap runs the reference operating point on one window
VIDEO_STEPS = 10


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
    720x1280 clip at the reference operating point but for the depth
    (``VIDEO_STEPS`` + ``VIDEO_STEPS`` steps; window 6, RAFT 20 iterations,
    parser 512), after a 2 + 2-step warm-up that holds
    every kernel call site to its plain version at the measured call's shapes
    (both windows' batches; the background trick's and the landmark net's
    GroupNorms); returns the kernels' launches over the measured call."""
    import torch

    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import init_aux_params

    opts = SwapOptions(ddim_steps=VIDEO_STEPS, inversion_steps=VIDEO_STEPS, window=FRAMES,
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
        ddim_steps=VIDEO_STEPS, inversion_steps=VIDEO_STEPS, raft_iters=opts.raft_iters,
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


# Phase sched: every window schedule of the video path. Each run: its
# SwapOptions fields, and whether its frames are a numpy array (the
# super-pack then streams) or a tensor on the card.
SCHED_RUNS = {
    "sequential": ({}, False),
    "pipeline_packs": (dict(pipeline_packs=True), False),
    "super_pack": (dict(invert_packs=2), False),
    "streaming": (dict(invert_packs=2), True),
    "super_pack_merged": (dict(invert_packs=2, merge_sampling=True), False),
    "cross_window_carry": (dict(cross_window_carry=True), False),
}
# the pipeline's methods a run must call (and how often) to show that its schedule ran
SCHED_PROGRAMS = ("_pipelined_step", "_final_pack", "_superpack", "_swap_frames_superpacked_streaming")
SCHED_FRAMES = 12  # (b): two 6-frame windows of 720x1280
SCHED_CARRY_FRAMES = 8  # (b)'s carry run: a window and a 2-frame one to carry into (cut from 12 for time)
SCHED_STEPS = 25  # (b) and phase opts: cut from the reference's 50 + 50 steps for time
GATE_FRAMES, GATE_WINDOW, GATE_STEPS, GATE_HW = 10, 3, 4, (512, 512)  # (a): three packs and a remainder
GATE_TOL = 1e-3  # (a): max abs on frames in [0, 1], fp32
LANDSCAPE = (12, 18, 24, 36, 48)  # (c): sampling eval batches (2 chunks x frames)


def _programs(pipe) -> dict:
    """Count the calls of the schedulers' programs on ``pipe``; returns {name: calls}."""
    calls = dict.fromkeys(SCHED_PROGRAMS, 0)
    for name in SCHED_PROGRAMS:
        real = getattr(pipe, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        setattr(pipe, name, counted)
    return calls


def _expected_programs(name: str, n: int, w: int) -> dict:
    """The program calls a run of ``name`` makes on n frames in packs of w."""
    want = dict.fromkeys(SCHED_PROGRAMS, 0)
    full = n // w
    if name == "pipeline_packs":
        want.update(_pipelined_step=full - 1, _final_pack=1)
    elif name in ("super_pack", "super_pack_merged", "streaming"):
        want["_superpack"] = full // 2
        want["_swap_frames_superpacked_streaming"] = int(name == "streaming")
    return want


def sched_pipe(model, opts, aux, name: str):
    from vface_torch.pipelines.video_swap import VideoSwapPipeline

    return VideoSwapPipeline(model, dataclasses.replace(opts, **SCHED_RUNS[name][0]), device="cuda", aux_params=aux)


def phase_sched_gate(seed: int) -> None:
    """Phase sched (a), the exactness gate at fp32: the SD-v1 inpainting model
    at fp32 with its conditioner (seeded), 10 frames of 512 x 512 at window
    3 (three packs and a 1-frame remainder), 4 + 4 steps, FGATS at 4096
    tokens, RAFT 20 iterations, parser 512. The sequential loop against each
    scheduler (pipelined packs, the super-pack with and without merged
    sampling, its streaming form) and against ``batch_windows=2`` (packs of
    two windows against separate windows): each within ``GATE_TOL`` max abs.
    The streaming form runs the landmark net and the parser per group, and
    the card's convolutions round by batch, which can flip a parse class and
    with it a keep-mask pixel: it is held to the loop with those two nets run
    in the same batches, and its distance from the plain loop is logged with
    what the batches alone move (landmarks, class maps).
    A copy of the packed run with the boundary masks forced to ones must
    miss that limit by 10x or more: the gate tells a boundary fault from
    round-off."""
    from unittest import mock

    import numpy as np
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines import video_swap as VS
    from vface_torch.pipelines.video_swap import SwapOptions
    from vface_torch.utils.convert import init_aux_params, init_params

    t_phase = time.perf_counter()
    cfg = ModelConfig.sd_v1_inpaint(dtype=torch.float32)
    model = VFaceModel(cfg, device="cuda", conditioner=True)
    model.load_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), conditioner=True))
    aux = init_aux_params(torch.Generator(device="cuda").manual_seed(seed + 1))
    opts = SwapOptions(ddim_steps=GATE_STEPS, inversion_steps=GATE_STEPS, window=GATE_WINDOW,
                       image_size=cfg.image_size, parser_size=512, raft_iters=20)
    frames = synthetic_clip(GATE_FRAMES, GATE_HW, seed + 30)
    source = synthetic_clip(1, GATE_HW, seed + 31)[0]
    out, wall, launched = {}, {}, {}
    runs = [*SCHED_RUNS, "sequential_grouped", "batch_windows_2", "batch_windows_2_unmasked"]
    runs.remove("cross_window_carry")  # not output-exact by design
    # the streaming form runs the landmark net and the parser per group of two
    # packs and per remaining pack; "sequential_grouped" runs them in the same
    # batches on the whole clip, the rest of its loop unchanged
    w = opts.window
    groups = [(0, 2 * w)] + [(s0, min(s0 + w, GATE_FRAMES)) for s0 in range(2 * w, GATE_FRAMES, w)]
    grouped = lambda fn: lambda x: (torch.cat([fn(x[a:b]) for a, b in groups]) if x.shape[0] == GATE_FRAMES
                                    else fn(x))
    for name in runs:
        fields = dict(batch_windows=2) if name.startswith("batch_windows") else SCHED_RUNS.get(name, ({},))[0]
        pipe = VS.VideoSwapPipeline(model, dataclasses.replace(opts, **fields), device="cuda", aux_params=aux)
        host = name == "streaming"
        if name == "sequential_grouped":
            pipe.detect_landmarks, pipe.parse_masks = grouped(pipe.detect_landmarks), grouped(pipe.parse_masks)
        calls = _programs(pipe)
        ones = lambda nf, window: np.ones((nf - 1,), np.float32)
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(VS, "pack_pair_mask", ones) if name.endswith("unmasked") else contextlib.nullcontext():
            out[name] = pipe.swap_video_frames(frames.cpu().numpy() if host else frames, source)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launched[name] = kernel_counts()
        want = _expected_programs(name, GATE_FRAMES, opts.window * pipe.opts.batch_windows)
        missing = [k for k in (*F32_EVAL_KERNELS, "gn_sums") if launched[name][k] == 0]
        if calls != want or missing:
            raise SystemExit(f"chip_smoke: sched gate run {name} called {calls}, not {want}, or launched no {missing}")
    seq = out["sequential"]
    err = {name: float((o - seq).abs().max()) for name, o in out.items() if not name.startswith("sequential")}
    broken = err.pop("batch_windows_2_unmasked")
    # streaming is held to the loop with its aux-net batches; beside it, what
    # those batches alone move: the landmarks, the class maps, the frames
    ungrouped = err.pop("streaming")
    err["streaming"] = float((out["streaming"] - out["sequential_grouped"]).abs().max())
    with torch.inference_mode():
        pipe = VS.VideoSwapPipeline(model, opts, device="cuda", aux_params=aux)
        lm = pipe.detect_landmarks(frames)
        lm_grouped = grouped(pipe.detect_landmarks)(frames)
        crops = pipe.align_crops(frames, landmarks=lm)[0]
        seg_equal = float((pipe.parse_masks(crops) == grouped(pipe.parse_masks)(crops)).float().mean())
    log("sched_gate_aux_batches", groups=",".join(f"{a}:{b}" for a, b in groups),
        landmarks_max_px=f"{float((lm - lm_grouped).abs().max()):.3e}", class_map_equal=f"{seg_equal:.6f}",
        sequential_grouped_vs_sequential_max_abs=f"{float((out['sequential_grouped'] - seq).abs().max()):.3e}",
        streaming_vs_sequential_max_abs=f"{ungrouped:.3e}")
    log("sched_gate", config="sd_v1_inpaint fp32 + conditioner", frames=GATE_FRAMES,
        frame_hw=f"{GATE_HW[0]}x{GATE_HW[1]}", window=GATE_WINDOW, ddim_steps=GATE_STEPS,
        inversion_steps=GATE_STEPS, flow_tokens=opts.flow_tokens, tol=GATE_TOL,
        **{f"{k}_max_abs": f"{v:.3e}" for k, v in err.items()}, unmasked_max_abs=f"{broken:.3e}",
        unmasked_over_tol=f"{broken / GATE_TOL:.1f}", **{f"{k}_s": f"{v:.3f}" for k, v in wall.items()},
        finite=all(bool(torch.isfinite(o).all()) for o in out.values()))
    log("sched_gate_launches", run="sequential", **{k: v for k, v in launched["sequential"].items() if v})
    del model, out, seq
    torch.cuda.empty_cache()
    log("sched_gate_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")
    failed = [k for k, v in err.items() if not v <= GATE_TOL]
    if failed:
        raise SystemExit(f"chip_smoke: at fp32 {failed} differ from the sequential loop by more than {GATE_TOL}")
    if not broken >= 10 * GATE_TOL:
        raise SystemExit(f"chip_smoke: the unmasked pack is within {broken:.3e} of the sequential loop: the gate "
                         "cannot tell a boundary fault from round-off")


def phase_sched(model, seed: int) -> dict:
    """Phase sched (b) and (c) on the ``video`` phase's model (bf16, with the
    conditioner). (b): every schedule of ``swap_video_frames`` on a seeded
    12-frame 720x1280 clip at the reference operating point but for the
    depth (``SCHED_STEPS`` + ``SCHED_STEPS`` steps; window 6, RAFT 20, parser
    512): the sequential loop, pipelined packs,
    the super-pack (tensor frames), its streaming form (numpy frames), the
    super-pack with merged sampling, and the cross-window carry (on the
    clip's first ``SCHED_CARRY_FRAMES`` frames); a 2 + 2-step
    warm-up of the schedulers with new batches (pipelined: b = 18, merged:
    b = 24) holds every kernel call at its new signatures to its plain
    version. Per run: wall seconds, frames/s, stage seconds, peak memory,
    launches per kernel, the calls of the schedule's programs and the uint8
    difference from the sequential run (mean and max, not gated); gated:
    shape, finite values in [0, 1], every kernel of the path launched, the
    programs called, and the carry run's first window within 1 uint8 level
    of the sequential run's. (c): :func:`sched_landscape`. Returns the
    sequential run's uint8 frames and launches, its clip and its options, for
    phase opts."""
    import numpy as np
    import torch

    from vface_torch.pipelines.video_swap import SwapOptions
    from vface_torch.utils.convert import init_aux_params

    t_phase = time.perf_counter()
    opts = SwapOptions(ddim_steps=SCHED_STEPS, inversion_steps=SCHED_STEPS, window=FRAMES,
                       image_size=model.cfg.image_size, parser_size=512, raft_iters=20)
    aux = init_aux_params(torch.Generator(device="cuda").manual_seed(seed))
    frames = synthetic_clip(SCHED_FRAMES, VIDEO_HW, seed + 20)
    frames_np = frames.cpu().numpy()
    source = synthetic_clip(1, VIDEO_HW, seed + 21)[0]
    short = dataclasses.replace(opts, ddim_steps=2, inversion_steps=2)
    t0 = time.perf_counter()
    with checked_sites("sched"):
        for name in ("pipeline_packs", "super_pack_merged"):
            sched_pipe(model, short, aux, name).swap_video_frames(frames, source)
    torch.cuda.synchronize()
    log("sched_warmup", runs="pipeline_packs,super_pack_merged", ddim_steps=2, inversion_steps=2,
        wall_s=f"{time.perf_counter() - t0:.3f}")
    u8_seq = None
    for name, (_, host) in SCHED_RUNS.items():
        n = SCHED_CARRY_FRAMES if name == "cross_window_carry" else SCHED_FRAMES
        pipe = sched_pipe(model, opts, aux, name)
        calls = _programs(pipe)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timings = {}
        t0 = time.perf_counter()
        out = pipe.swap_video_frames(frames_np[:n] if host else frames[:n], source, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        u8 = _u8(out).astype(np.int16)
        if u8_seq is None:
            u8_seq, seq_launches = u8, launches
        diff = np.abs(u8 - u8_seq[:n]).astype(np.float64)
        w0 = int(np.abs(u8[:FRAMES] - u8_seq[:FRAMES]).max())
        finite = bool(torch.isfinite(out).all())
        log("sched_run", run=name, frames=n, frame_hw=f"{VIDEO_HW[0]}x{VIDEO_HW[1]}", window=FRAMES,
            wall_s=f"{wall:.3f}", frames_per_s=f"{n / wall:.4f}", **stage_line(timings),
            peak_gib=f"{peak:.2f}", mean_level_diff=f"{diff.mean():.4f}", max_level_diff=int(diff.max()),
            window0_max_level_diff=w0, **{k: v for k, v in calls.items() if v},
            **{k: v for k, v in launches.items() if v})
        want = _expected_programs(name, n, opts.window)
        if not (tuple(out.shape) == (n, *VIDEO_HW, 3) and finite
                and float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
            raise SystemExit(f"chip_smoke: sched run {name}'s output has the wrong shape, is not finite or "
                             "leaves [0, 1]")
        missing = [k for k in SWAP_KERNELS if launches[k] == 0]
        stray = [k for k in launches if k not in SWAP_KERNELS and launches[k]]
        if missing or stray or calls != want:
            raise SystemExit(f"chip_smoke: sched run {name} launched no {missing} / stray {stray} kernels, or "
                             f"called {calls}, not {want}")
        if name == "cross_window_carry" and w0 > 1:
            raise SystemExit(f"chip_smoke: the carry run's first window is {w0} levels from the sequential run's")
        del out
    sched_landscape(model, seed)
    log("sched_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")
    return dict(u8=u8_seq, launches=seq_launches, frames=frames, source=source, aux=aux, opts=opts)


def sched_landscape(model, seed: int) -> None:
    """Phase sched (c): one hooked sampling UNet eval (2 chunks of b/2 frames,
    FSAI + FGATS on a seeded flow, 64^2 latents) at each batch b of
    ``LANDSCAPE``, one warm-up and three timed calls each (host clock,
    synchronised): ms, ms per row and peak memory; the device is the card's
    whatever the batch, so a jump in ms per row shows a convolution or
    kernel choice that a batch triggers."""
    import torch

    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops.attention import FusionConfig

    cfg = model.cfg
    hl, d = cfg.latent_size, cfg.unet.context_dim
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", two_chunk_replace=False), chunks=2)
    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    for b in LANDSCAPE:
        f = b // 2
        x9 = torch.randn((b, hl, hl, 9), generator=g, device="cuda")
        ts = torch.full((b,), 500, device="cuda")
        ctx = torch.randn((b, 1, d), generator=g, device="cuda")
        flow = torch.randn((f - 1, hl, hl, 2), generator=g, device="cuda")
        with torch.inference_mode():
            model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        log("sched_landscape", batch=b, ms="/".join(f"{t:.2f}" for t in times),
            ms_per_row=f"{min(times) / b:.3f}", peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        if b == 2 * FRAMES:
            silu_forms(model, x9, ts, ctx, flow, inj)
        del x9, ctx, flow


def silu_forms(model, x9, ts, ctx, flow, inj) -> None:
    """One sampling eval with the UNet's SiLU rounded as JAX's is at bf16 (four
    more elementwise launches per SiLU) and with ``F.silu`` (one), in turns,
    five rounds of three evals each: what the rounding costs. Prints each
    form's evals (ms) and their median."""
    from unittest import mock

    import torch

    from vface_torch.models import unet

    times = {"jax_rounding": [], "fused": []}
    for form in ("jax_rounding", "fused", "fused", "jax_rounding") * 2 + ("jax_rounding", "fused"):
        patch = mock.patch.object(unet, "nonlinearity", torch.nn.functional.silu)
        with torch.inference_mode(), patch if form == "fused" else contextlib.nullcontext():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.apply_model(x9, ts, ctx, flow=flow, injection=inj)
                torch.cuda.synchronize()
                times[form].append((time.perf_counter() - t0) * 1e3)
    median = lambda v: sorted(v)[len(v) // 2]
    log("silu_forms", batch=x9.shape[0], **{f"{k}_median_ms": f"{median(v):.2f}" for k, v in times.items()},
        **{f"{k}_ms": "/".join(f"{t:.1f}" for t in v) for k, v in times.items()})


# Phase opts: the sampler options on the video phase's model, on phase sched's
# 12-frame 720p clip at sched's depth. Each run: its
# SwapOptions fields.
OPTS_RUNS = {
    "sequential_interval2": dict(encoder_interval=2),
    "sequential_interval3": dict(encoder_interval=3),
    "super_pack_merged_interval2": dict(encoder_interval=2, invert_packs=2, merge_sampling=True),
    "sequential_eta": dict(eta=0.5),
}
OPTS_KERNELS = ("flash_attention", "geglu_ff", "geglu_ff_wide")  # K1, K2, K9: the UNet's
# fp32 throughout, TF32 off: summation order only, amplified by the random
# weights over the steps (the latents reach ~10): max abs over each output's
# peak (at least 1)
OPTS_GATE_TOL = 1e-4


def phase_opts(model, seed: int, base: dict) -> None:
    """Phase opts on the ``video`` phase's model (bf16, with the conditioner):
    encoder propagation and eta > 0 through ``swap_video_frames`` on phase
    sched's 12-frame 720x1280 clip at sched's depth (``SCHED_STEPS`` +
    ``SCHED_STEPS`` steps; window 6, RAFT 20, parser 512): the sequential loop at
    ``encoder_interval`` 2 and 3, the super-pack with merged sampling at 2, and
    the sequential loop at eta = 0.5, after a warm-up that holds every kernel
    call of one cached sampling eval and one CFG inversion eval (b = 12) to its
    plain version. Per run: wall seconds, frames/s, invert and sample seconds,
    K1/K2/K9 launches, peak memory and the uint8 difference from phase sched's
    exact sequential run (reported, not gated: encoder propagation
    approximates, and eta changes the result); gated: finite frames of the
    clip's shape in [0, 1], and fewer K1 launches than the exact run where
    the cache is on. Then :func:`phase_opts_gate`."""
    import numpy as np
    import torch

    from vface_torch.samplers.inversion import ddim_invert
    from vface_torch.pipelines.video_swap import VideoSwapPipeline

    t_phase = time.perf_counter()
    opts, frames, source, aux = base["opts"], base["frames"], base["source"], base["aux"]
    pipe = VideoSwapPipeline(model, opts, device="cuda", aux_params=aux)
    w = window_inputs(model, FRAMES, seed + 40)
    hl = model.cfg.latent_size
    g = torch.Generator(device="cuda").manual_seed(seed + 41)
    z = torch.randn((FRAMES, hl, hl, 4), generator=g, device="cuda")
    inpaint = torch.randn((FRAMES, hl, hl, 4), generator=g, device="cuda")
    mask = torch.ones((FRAMES, hl, hl, 1), device="cuda")
    x9 = torch.cat([z, inpaint, mask], dim=-1).repeat(2, 1, 1, 1)
    ctx = torch.cat([w["uncond"], w["cond"]])
    inj = dataclasses.replace(pipe.injection, chunks=2,
                              input_blocks=dataclasses.replace(pipe.injection.input_blocks, two_chunk_replace=False))
    flow = pipe._latent_flow(w["flow"])
    t0 = time.perf_counter()
    with checked_sites("opts", expect=OPTS_KERNELS), torch.inference_mode():
        ts = lambda v: torch.full((2 * FRAMES,), v, dtype=torch.int64, device="cuda")
        _, cache = model.apply_model(x9, ts(981), ctx, flow=flow, injection=inj, return_encoder_cache=True)
        model.apply_model(x9, ts(961), ctx, flow=flow, injection=inj, encoder_cache=cache,
                          return_encoder_cache=True)
        ddim_invert(model, z, w["inverse_cond"], inpaint, mask, num_steps=1, uncond=w["uncond"], cfg_scale=3.0)
    torch.cuda.synchronize()
    log("opts_warmup", evals="cached sampling b=12, CFG inversion b=12", wall_s=f"{time.perf_counter() - t0:.3f}")
    del cache
    seq_k1 = base["launches"]["flash_attention"]
    for name, fields in OPTS_RUNS.items():
        pipe = VideoSwapPipeline(model, dataclasses.replace(opts, **fields), device="cuda", aux_params=aux)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        timings = {}
        t0 = time.perf_counter()
        out = pipe.swap_video_frames(frames, source, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        diff = np.abs(_u8(out).astype(np.int16) - base["u8"]).astype(np.float64)
        finite = bool(torch.isfinite(out).all())
        log("opts_run", run=name, frames=SCHED_FRAMES, frame_hw=f"{VIDEO_HW[0]}x{VIDEO_HW[1]}", window=FRAMES,
            ddim_steps=opts.ddim_steps, inversion_steps=opts.inversion_steps, wall_s=f"{wall:.3f}",
            frames_per_s=f"{SCHED_FRAMES / wall:.4f}", invert_s=f"{timings.get('invert', 0.0):.3f}",
            sample_s=f"{timings.get('sample', 0.0):.3f}", **{k: launches[k] for k in OPTS_KERNELS},
            exact_flash_attention=seq_k1, peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            mean_level_diff=f"{diff.mean():.4f}", max_level_diff=int(diff.max()))
        if not (tuple(out.shape) == (SCHED_FRAMES, *VIDEO_HW, 3) and finite
                and float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
            raise SystemExit(f"chip_smoke: opts run {name}'s output has the wrong shape, is not finite or leaves [0, 1]")
        if fields.get("encoder_interval", 1) > 1 and not launches["flash_attention"] < seq_k1:
            raise SystemExit(f"chip_smoke: opts run {name} launched {launches['flash_attention']} K1s, not fewer "
                             f"than the exact run's {seq_k1}")
        del out
    phase_opts_gate(seed)
    log("opts_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


def phase_opts_gate(seed: int) -> None:
    """Phase opts' fp32 gate: the tiny fp32 model (seeded) on the card against
    the same calls on the CPU (which the tests hold to the JAX package), same
    inputs: ``vface_sample`` (8 steps, FSAI + FGATS, the 3-chunk batch) with
    ``encoder_interval=2``, eta = 0.5 (one explicit noise stack) and
    ``src_start``, and ``ddim_invert`` (8 steps) with CFG (scale 3) and
    ``encoder_interval=2``: each output within ``OPTS_GATE_TOL`` of its
    peak magnitude (at least 1)."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.models.unet import InjectionSpec
    from vface_torch.ops.attention import FusionConfig
    from vface_torch.samplers.inversion import ddim_invert
    from vface_torch.samplers.vface import vface_sample
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig.tiny(image_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    f, hl, d, steps = 3, 16, cfg.unet.context_dim, 8
    g = torch.Generator().manual_seed(seed + 5)
    r = lambda *shape: torch.randn(shape, generator=g)
    inputs = dict(x_T=r(f, hl, hl, 4), cond=r(f, 1, d), uncond=r(f, 1, d), tcond=r(f, 1, d),
                  inv=r(steps, f, hl, hl, 4), inpaint=r(f, hl, hl, 4), mask=(r(f, hl, hl, 1) > 0).float(),
                  flow=r(f - 1, hl, hl, 2) * 1.5, src=r(f, hl, hl, 4))
    noise = r(steps, f, hl, hl, 4)
    inj = InjectionSpec(input_blocks=FusionConfig("flow_fix", flow_tokens=hl * hl), chunks=3)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = VFaceModel(cfg, device=dev)
        model.load_params(params)
        x = {k: v.to(dev) for k, v in inputs.items()}
        with torch.inference_mode():
            z, traj = vface_sample(model, x["x_T"], x["cond"], x["uncond"], x["tcond"], x["inv"], x["inpaint"],
                                   x["mask"], inj, flow=x["flow"], num_steps=steps, cfg_scale=3.0, eta=0.5,
                                   src_start=x["src"], noise=lambda idx, shape: noise[idx],
                                   encoder_interval=2)
            x_T, lat = ddim_invert(model, x["x_T"], x["cond"], x["inpaint"], x["mask"], num_steps=steps,
                                   uncond=x["uncond"], cfg_scale=3.0, encoder_interval=2)
        outs[dev] = [o.cpu() for o in (z, traj, x_T, lat)]
    err = [float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"])]
    peak = [max(1.0, float(b.abs().max())) for b in outs["cpu"]]
    names = ("sample_z0", "sample_traj", "invert_xT", "invert_latents")
    log("opts_gate", config=f"tiny fp32, {f} frames of {hl}^2 latents, {steps} steps",
        **{f"{n}_max_abs": f"{e:.3e}" for n, e in zip(names, err)},
        **{f"{n}_peak": f"{p:.3f}" for n, p in zip(names, peak)}, tol=f"{OPTS_GATE_TOL} of the peak")
    if not all(e <= OPTS_GATE_TOL * p for e, p in zip(err, peak)):
        raise SystemExit("chip_smoke: the card's tiny samplers with the cache, eta, src_start or CFG disagree "
                         "with the CPU's")


MULTIFACE_FRAMES, MULTIFACE_SIZE = 12, 720  # a 720^2 two-face scene rolled 2 px a frame
# the multi-face run's depth: cut from the reference's 50 + 50 steps for time
# (the script's whole run stays near 600 s); its widths are the reference's
MULTIFACE_STEPS = 20


def phase_multiface(model, seed: int, base: dict) -> None:
    """Phase multiface on the ``video`` phase's model: a seeded two-face
    ``render_scene`` (the first seed from ``seed`` with exactly two faces) at
    720^2, rolled 2 px a frame over 12 frames. The detector (shipped weights)
    on the card against the CPU: boxes within 0.5 px, scores within 1e-4, the
    same order, and each face found in every frame (a box with score > 0.3
    whose centre is within half the face's size, as the JAX package's
    detector test counts a hit). Then ``swap_video_frames_multiface`` at the
    reference operating point but for the depth (top_k 2, threshold 0.3;
    ``MULTIFACE_STEPS`` + ``MULTIFACE_STEPS`` steps, window 6, RAFT 20, parser
    512): wall seconds, seconds per face, frames/s, peak
    memory and launches; gated: finite frames in [0, 1], both faces swapped
    and every kernel of the swap path launched."""
    import numpy as np
    import torch

    from vface_torch.pipelines.video_swap import VideoSwapPipeline, swap_video_frames_multiface
    from vface_torch.preprocess.detector import FaceDetector, decode_detections
    from vface_torch.preprocess.synthetic_faces import render_scene

    t_phase = time.perf_counter()
    for scene_seed in range(seed, seed + 200):
        img, boxes, valid = render_scene(np.random.default_rng(scene_seed), MULTIFACE_SIZE)
        if valid.sum() == 2:
            break
    else:
        raise SystemExit("chip_smoke: no two-face scene in 200 seeds")
    frames = np.stack([np.roll(img, 2 * i, axis=1) for i in range(MULTIFACE_FRAMES)]).astype(np.float32)
    gts = boxes[valid]
    aux = base["aux"]
    opts = dataclasses.replace(base["opts"], ddim_steps=MULTIFACE_STEPS, inversion_steps=MULTIFACE_STEPS)
    pipe = VideoSwapPipeline(model, opts, device="cuda", aux_params=aux)
    got_boxes, got_scores = (o.cpu() for o in pipe.detect_faces(frames, top_k=2))
    det = FaceDetector().eval()
    det.load_state_dict({k: v.cpu() for k, v in aux["detector"].items()})
    with torch.inference_mode():
        want_boxes, want_scores = decode_detections(*det(torch.from_numpy(frames)), top_k=2,
                                                    image_hw=(MULTIFACE_SIZE, MULTIFACE_SIZE))
    box_err = float((got_boxes - want_boxes).abs().max())
    score_err = float((got_scores - want_scores).abs().max())
    hits = 0
    for i in range(MULTIFACE_FRAMES):
        for cx, cy, fw, fh in gts:
            dist = np.hypot(got_boxes[i, :, 0].numpy() - (cx + 2 * i), got_boxes[i, :, 1].numpy() - cy)
            dist = np.where(got_scores[i].numpy() > 0.3, dist, np.inf)
            hits += int(dist.min() < 0.5 * max(fw, fh))
    log("multiface_detect", scene_seed=scene_seed, frames=MULTIFACE_FRAMES,
        frame_hw=f"{MULTIFACE_SIZE}x{MULTIFACE_SIZE}", faces=len(gts), box_max_px=f"{box_err:.3e}",
        score_max_abs=f"{score_err:.3e}", tol="boxes 0.5 px, scores 1e-4", hits=hits,
        of=MULTIFACE_FRAMES * len(gts), mean_scores=",".join(f"{v:.4f}" for v in got_scores.mean(dim=0).tolist()))
    if not (box_err <= 0.5 and score_err <= 1e-4 and hits == MULTIFACE_FRAMES * len(gts)):
        raise SystemExit("chip_smoke: the card's face detector disagrees with the CPU's or misses a face")
    faces = []
    real = pipe.swap_video_frames

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        faces.append(time.perf_counter() - t0)
        return out

    pipe.swap_video_frames = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    out = swap_video_frames_multiface(pipe, frames, base["source"], top_k=2, score_threshold=0.3, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    finite = bool(torch.isfinite(out).all())
    log("multiface", frames=MULTIFACE_FRAMES, frame_hw=f"{MULTIFACE_SIZE}x{MULTIFACE_SIZE}", faces=len(faces),
        ddim_steps=opts.ddim_steps, inversion_steps=opts.inversion_steps,
        wall_s=f"{wall:.3f}", face_s=",".join(f"{v:.3f}" for v in faces),
        frames_per_s=f"{MULTIFACE_FRAMES / wall:.4f}", **stage_line(timings),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        mean_abs_change=f"{float((out - torch.from_numpy(frames)).abs().mean()):.4f}",
        **{k: v for k, v in launches.items() if v})
    if not (tuple(out.shape) == frames.shape and finite and float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
        raise SystemExit("chip_smoke: the multi-face output has the wrong shape, is not finite or leaves [0, 1]")
    missing = [k for k in SWAP_KERNELS if launches[k] == 0]
    if len(faces) != 2 or missing:
        raise SystemExit(f"chip_smoke: the multi-face run swapped {len(faces)} faces, not 2, or launched no {missing}")
    log("multiface_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


def phase_sched_kernels() -> dict:
    """K1, K2 and K9 at the schedulers' new batches, against their plain
    versions, timed: b = 18 (pipelined packs: 12 sampling rows and 6
    inversion rows) and b = 24 (merged sampling); returns the rows, which
    join each kernel's row list."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    rows = {"flash_attention": [], "geglu_ff": [], "geglu_ff_wide": []}
    for b in (3 * FRAMES, 4 * FRAMES):
        rows["flash_attention"] += k1_rows(b, randn)
        rows["geglu_ff"] += ff_rows("geglu_ff", b, randn)
        rows["geglu_ff_wide"] += ff_rows("geglu_ff_wide", b, randn)
    return rows


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


CLI_FRAMES, CLI_SHORT = 12, 3  # pair A: two windows (one pack of two); pair B: one short window
CLI_STEPS = 25  # the CLI's 50 + 50 steps cut for the script's time
_DONE = re.compile(r"\[done\] (\S+): (\d+) frames, swap ([\d.]+) s \(([\d.]+) frames/s\), sink ([\d.]+) s")


def _u8(frames01):
    """Frames in [0, 1] (a tensor) -> uint8 numpy, as the CLI quantizes them."""
    import torch

    return (frames01.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def write_cli_inputs(root, seed: int) -> dict:
    """The CLI phase's inputs, written with the port's writers: pair A, a
    12-frame 720x1280 clip as Y4M with a 1.2 s mono 16-bit WAV beside it;
    pair B, a 3-frame clip with a ``masks:`` directory of crop-space parse
    maps (an ellipse of skin, hair above it); a source PNG; the configs in
    ``scripts/generate_config.py``'s format (both pairs; pair A alone)."""
    import wave

    import numpy as np

    from vface_torch.io.image import write_png
    from vface_torch.io.video import write_y4m

    os.makedirs(root, exist_ok=True)
    write_y4m(os.path.join(root, "pair_a.y4m"), _u8(synthetic_clip(CLI_FRAMES, VIDEO_HW, seed)), fps=10)
    t = np.arange(int(16000 * 1.2)) / 16000.0
    with wave.open(os.path.join(root, "pair_a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.sin(2 * np.pi * 440.0 * t) * 8000).astype(np.int16).tobytes())
    write_y4m(os.path.join(root, "pair_b.y4m"), _u8(synthetic_clip(CLI_SHORT, VIDEO_HW, seed + 2)), fps=10)
    write_png(os.path.join(root, "source.png"), _u8(synthetic_clip(1, VIDEO_HW, seed + 1))[0])
    masks = os.path.join(root, "masks_b")
    os.makedirs(masks, exist_ok=True)
    s = 512
    yy, xx = np.mgrid[:s, :s].astype(np.float32)
    for i in range(CLI_SHORT):
        face = ((yy - s * (0.55 + 0.005 * i)) / (s * 0.32)) ** 2 + ((xx - s * 0.5) / (s * 0.25)) ** 2 <= 1.0
        hair = ((yy - s * 0.22) / (s * 0.16)) ** 2 + ((xx - s * 0.5) / (s * 0.3)) ** 2 <= 1.0
        write_png(os.path.join(masks, f"{i}.png"), np.where(face, 1, np.where(hair, 17, 0)).astype(np.uint8))
    pair_a = f"- video: {root}/pair_a.y4m\n  source: {root}/source.png\n"
    pair_b = f"- video: {root}/pair_b.y4m\n  source: {root}/source.png\n  masks: {masks}\n"
    with open(os.path.join(root, "both.yaml"), "w") as f:
        f.write(pair_a + pair_b)
    with open(os.path.join(root, "pair_a.yaml"), "w") as f:
        f.write(pair_a)
    return {"both": os.path.join(root, "both.yaml"), "a": os.path.join(root, "pair_a.yaml")}


class _Tee:
    """Writes to the real standard output and keeps a copy."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()


@contextlib.contextmanager
def stage_timings():
    """Every ``swap_video_frames`` call made inside gets a ``timings`` dict
    (its stages' seconds, the device synchronised at each stage boundary);
    yields the list of those dicts, one per call."""
    from unittest import mock

    from vface_torch.pipelines.video_swap import VideoSwapPipeline

    real = VideoSwapPipeline.swap_video_frames
    calls = []

    def timed(self, *args, **kw):
        calls.append({})
        return real(self, *args, **kw, timings=calls[-1])

    with mock.patch.object(VideoSwapPipeline, "swap_video_frames", timed):
        yield calls


def run_cli(argv: list) -> dict:
    """``vface_video_swap.main(argv)``, in process, under :func:`stage_timings`;
    returns {"done": {name: (frames, swap_s, frames_per_s, sink_s)}, "skip":
    [names], "wall_s", "stages": {name: {stage: s}}}. A ``[fail]`` line or a
    non-zero return fails the script."""
    import torch

    from vface_torch.scripts import vface_video_swap

    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), stage_timings() as stages:
        rc = vface_video_swap.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = "".join(tee.parts)
    if rc != 0 or "[fail]" in text:
        raise SystemExit(f"chip_smoke: vface_video_swap {' '.join(argv)} failed (rc {rc})")
    done = {m[1]: (int(m[2]), float(m[3]), float(m[4]), float(m[5])) for m in _DONE.finditer(text)}
    skip = re.findall(r"\[skip\] (\S+):", text)
    return {"done": done, "skip": skip, "wall_s": wall, "stages": dict(zip(done, stages))}


def cli_flow_batches(seed: int) -> None:
    """The flow stage's cost per frame pair (512^2 crops, RAFT 20 iterations,
    seeded): RAFT itself on 5, 6 and 11 pairs in one batch, and
    ``compute_flow`` (at most ``RAFT_MAX_PAIRS`` pairs a call) on a window's 6
    frames and a pack's 12, timed in turns 6, 12, 12, 6."""
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import init_aux_params

    pipe = VideoSwapPipeline(VFaceModel(ModelConfig.tiny(), device="cuda"), SwapOptions(), device="cuda",
                             aux_params=init_aux_params(torch.Generator(device="cuda").manual_seed(seed)))
    crops = synthetic_clip(CLI_FRAMES, (512, 512), seed)

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    x = crops * 2 - 1
    with torch.inference_mode():
        raft = {p: ms(lambda: pipe.raft(x[1:p + 1], x[:p])) for p in (5, 6, 11)}
    chunked = {6: [], 12: []}
    for n in (6, 12, 12, 6):
        chunked[n].append(ms(lambda: pipe.compute_flow(crops[:n])))
    log("cli_flow_batch", raft_iters=20, crops="512^2",
        raft_one_batch_ms_per_pair=",".join(f"{p}:{t / p:.1f}" for p, t in raft.items()),
        compute_flow_ms=",".join(f"{n}:{'/'.join(f'{t:.1f}' for t in v)}" for n, v in chunked.items()),
        compute_flow_ms_per_pair=",".join(f"{n}:{min(v) / (n - 1):.1f}" for n, v in chunked.items()))


def stage_line(stages: dict) -> dict:
    """A swap's stage seconds as log fields."""
    return {f"{k}_s": f"{v:.3f}" for k, v in stages.items()}


def _read_frames(frame_dir: str, n: int):
    """The sink's PNG frames 0..n-1 as int16 (N, H, W, 3)."""
    import numpy as np

    from vface_torch.io.image import read_png

    return np.stack([read_png(os.path.join(frame_dir, f"{i}.png")) for i in range(n)]).astype(np.int16)


def check_cli_outputs(outdir: str, name: str, frames: int, windows: dict, audio: bool) -> dict:
    """The AVI is RIFF/AVI with a video stream (and an audio stream where the
    pair has a WAV), the Y4M reads back with the frames' count and size, the
    GIF lasts as many frames at 10 fps, the manifest lists ``windows`` ({start: frames}),
    and every frame PNG is there; returns the checks."""
    from PIL import Image

    from vface_torch.io.video import read_y4m

    base = os.path.join(outdir, name)
    with open(base + ".avi", "rb") as f:
        avi = f.read()
    at = avi.index(b"LIST", 12)
    hdrl = avi[at:at + 8 + int.from_bytes(avi[at + 4:at + 8], "little")]
    streams = [hdrl[i + 8:i + 12].decode() for i in range(len(hdrl)) if hdrl[i:i + 4] == b"strh"]
    y4m, fps = read_y4m(base + ".y4m")
    with Image.open(base + ".gif") as g:  # PIL merges equal consecutive frames, adding their durations
        gif_frames = g.n_frames
        gif_ms = 0
        for i in range(gif_frames):
            g.seek(i)
            gif_ms += g.info["duration"]
    with open(base + ".manifest.json") as f:
        man = {int(k): v["frames"] for k, v in json.load(f)["windows"].items()}
    pngs = sum(os.path.exists(os.path.join(base + "_frames", f"{i}.png")) for i in range(frames))
    checks = {"avi_ok": avi[:4] == b"RIFF" and avi[8:12] == b"AVI ",
              "streams_ok": streams == (["vids", "auds"] if audio else ["vids"]),
              "y4m_ok": tuple(y4m.shape) == (frames, *VIDEO_HW, 3) and fps == 10,
              "gif_ok": gif_ms == frames * 100, "manifest_ok": man == windows, "pngs_ok": pngs == frames}
    log("cli_outputs", video=name, streams="+".join(streams), y4m_shape=tuple(y4m.shape), gif_frames=gif_frames,
        gif_ms=gif_ms, manifest=",".join(f"{k}:{v}" for k, v in sorted(man.items())), pngs=pngs, **checks)
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the CLI's outputs for {name} fail their checks: {checks}")
    return checks


def phase_cli(seed: int) -> None:
    """The video-swap CLI (``python -m vface_torch.scripts.vface_video_swap``)
    on the card, through ``main(argv)`` at its defaults but for the depth
    (SD-v1 inpainting with its conditioner, seeded; ``CLI_STEPS`` +
    ``CLI_STEPS`` steps, window 6, scale 3.0, fps 10, parser 512): a 2 + 2-step warm-up at ``--batch_windows 2`` with every
    kernel call held to its plain version (the packed shapes: K1 at b = 24,
    K2 at M = 24 * 4096 and 24 * 1024, K9 at 24 * 256 and 24 * 64); run A
    (both pairs, separate windows: outputs checked, frames/s, the sink's
    seconds, peak memory, launches); run R (pair A's AVI deleted and its
    second window dropped from the manifest: pair B is skipped, pair A
    recomputes one window, within 1 uint8 level of run A); run P (pair A
    with ``--batch_windows 2``: one 12-frame pack; frames/s, peak memory and
    the difference from run A, printed, not gated); then
    :func:`cli_flow_batches`."""
    import tempfile

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vface_cli_")
    try:
        cfg = write_cli_inputs(os.path.join(root, "in"), seed)
        base = ["--seed", str(seed), "--ddim_steps", str(CLI_STEPS), "--inversion_steps", str(CLI_STEPS)]
        out = lambda run: ["--outdir", os.path.join(root, run)]
        t0 = time.perf_counter()
        with checked_sites("cli"):
            warm = run_cli(["--config", cfg["both"], *out("warmup"), *base, "--ddim_steps", "2",
                            "--inversion_steps", "2", "--batch_windows", "2"])
        log("cli_warmup", ddim_steps=2, inversion_steps=2, batch_windows=2, wall_s=f"{time.perf_counter() - t0:.3f}",
            videos=",".join(sorted(warm["done"])))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run_a = run_cli(["--config", cfg["both"], *out("run_a"), *base])
        launches_a = kernel_counts()
        peak_a = torch.cuda.max_memory_allocated() / 2**30
        for name, (n, swap_s, fps, sink_s) in sorted(run_a["done"].items()):
            log("cli_run_a", video=name, frames=n, swap_s=f"{swap_s:.3f}", frames_per_s=f"{fps:.4f}",
                sink_s=f"{sink_s:.3f}", **stage_line(run_a["stages"][name]))
        log("cli_run_a_total", wall_s=f"{run_a['wall_s']:.3f}", peak_gib=f"{peak_a:.2f}", batch_windows=1,
            **{k: v for k, v in launches_a.items() if v})
        if sorted(run_a["done"]) != ["pair_a", "pair_b"]:
            raise SystemExit(f"chip_smoke: run A finished {sorted(run_a['done'])}, not both pairs")
        missing = [k for k in SWAP_KERNELS if launches_a[k] == 0]
        stray = [k for k in launches_a if k not in SWAP_KERNELS and launches_a[k]]
        if missing or stray:
            raise SystemExit(f"chip_smoke: the CLI launched no {missing} / stray {stray} kernels")
        dir_a = os.path.join(root, "run_a")
        check_cli_outputs(dir_a, "pair_a", CLI_FRAMES, {0: 6, 6: 6}, audio=True)
        check_cli_outputs(dir_a, "pair_b", CLI_SHORT, {0: CLI_SHORT}, audio=False)
        frames_a = _read_frames(os.path.join(dir_a, "pair_a_frames"), CLI_FRAMES)

        os.remove(os.path.join(dir_a, "pair_a.avi"))
        path = os.path.join(dir_a, "pair_a.manifest.json")
        with open(path) as f:
            man = json.load(f)
        del man["windows"]["6"]
        with open(path, "w") as f:
            json.dump(man, f)
        reset_counts()
        run_r = run_cli(["--config", cfg["both"], *out("run_a"), *base])
        launches_r = kernel_counts()
        frames_r = _read_frames(os.path.join(dir_a, "pair_a_frames"), CLI_FRAMES)
        diff = np.abs(frames_r - frames_a)
        per_window = launches_a["flash_attention"] / 3  # run A computed three windows
        n, swap_s, fps, sink_s = run_r["done"].get("pair_a", (0, 0.0, 0.0, 0.0))
        log("cli_run_r", skipped=",".join(run_r["skip"]), video="pair_a", frames=n,
            resumed_window_swap_s=f"{swap_s:.3f}", sink_s=f"{sink_s:.3f}", wall_s=f"{run_r['wall_s']:.3f}",
            **stage_line(run_r["stages"].get("pair_a", {})),
            k1_launches=launches_r["flash_attention"], k1_per_window=f"{per_window:g}",
            max_level_diff=int(diff.max()), bit_equal_share=f"{float((diff == 0).mean()):.5f}",
            recomputed_bit_equal_share=f"{float((diff[6:] == 0).mean()):.5f}", tol="1 level")
        check_cli_outputs(dir_a, "pair_a", CLI_FRAMES, {0: 6, 6: 6}, audio=True)
        if not (run_r["skip"] == ["pair_b"] and sorted(run_r["done"]) == ["pair_a"]
                and launches_r["flash_attention"] == per_window and diff.max() <= 1):
            raise SystemExit("chip_smoke: the resumed run skipped, recomputed or differed where it should not")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run_p = run_cli(["--config", cfg["a"], *out("run_p"), *base, "--batch_windows", "2"])
        launches_p = kernel_counts()
        peak_p = torch.cuda.max_memory_allocated() / 2**30
        dir_p = os.path.join(root, "run_p")
        check_cli_outputs(dir_p, "pair_a", CLI_FRAMES, {0: CLI_FRAMES}, audio=True)
        frames_p = _read_frames(os.path.join(dir_p, "pair_a_frames"), CLI_FRAMES)
        diff = np.abs(frames_p - frames_a).astype(np.float64)
        n, swap_s, fps, sink_s = run_p["done"]["pair_a"]
        log("cli_run_p", video="pair_a", frames=n, batch_windows=2, swap_s=f"{swap_s:.3f}",
            frames_per_s=f"{fps:.4f}", run_a_frames_per_s=f"{run_a['done']['pair_a'][2]:.4f}",
            sink_s=f"{sink_s:.3f}", **stage_line(run_p["stages"]["pair_a"]), peak_gib=f"{peak_p:.2f}",
            mean_level_diff=f"{diff.mean():.4f}",
            max_level_diff=int(diff.max()), **{k: v for k, v in launches_p.items() if v})
        if launches_p["flash_attention"] != per_window:  # one pack: the evals of one window, at twice the batch
            raise SystemExit(f"chip_smoke: run P launched K1 {launches_p['flash_attention']} times, "
                             f"not one pack's {per_window:g}")
        cli_flow_batches(seed)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    log("cli_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


TRAIN_CLI_STEPS, TRAIN_CLI_RESUME, TRAIN_CLI_IMAGES = 4, 2, 6  # steps, resumed steps, synthetic pairs
_STAGES = re.compile(r"^\[train\] stages (\{.*\})$", re.M)


def _clean_steps(n: int, every: int) -> list:
    """Steps whose ``sec_per_it`` (log_every 1) holds the step alone: not the
    first (the warm-up) and not one after an image log or a save."""
    return [s for s in range(2, n + 1) if (s - 1) % every]


def _save_bytes(cfg) -> tuple:
    """(bytes of a save_last, bytes of a save_monitored) at fp32, reckoned from
    the state's numel: every parameter, plus Adam's two moments of the
    trainable set in save_last."""
    import torch

    from vface_torch.models.ldm import VFaceModel
    from vface_torch.pipelines.train import trainable_mask

    meta = VFaceModel(cfg, device="meta", conditioner=True)
    trainable_mask(meta)
    n_all = sum(p.numel() for p in meta.parameters())
    n_train = sum(p.numel() for p in meta.parameters() if p.requires_grad)
    del meta
    torch.cuda.empty_cache()
    return 4 * (n_all + 2 * n_train), 4 * n_all


def phase_train_cli(seed: int) -> dict:
    """The training CLI (``vface_torch.scripts.train.main``) in process at its
    full width (SD-v1 inpainting with its conditioner, seeded; batch 1 at
    512^2) on a synthetic CelebA-HQ-layout directory: 4 steps (log_every 1,
    image_log_every 2, ckpt_every 4: one save), then ``--resume`` for 2 more (saving on
    exit only). Returns the launches per step of the first run."""
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from vface_torch.data.datasets import write_synthetic_celeba
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines import train_driver
    from vface_torch.pipelines.train import trainable_mask
    from vface_torch.scripts import train as cli
    from vface_torch.utils.convert import init_params

    t_phase = time.perf_counter()
    cfg = ModelConfig.sd_v1_inpaint()
    root = tempfile.mkdtemp(prefix="vface_train_cli_")
    try:
        data, logdir = os.path.join(root, "celeba"), os.path.join(root, "logs")
        t0 = time.perf_counter()
        write_synthetic_celeba(data, TRAIN_CLI_IMAGES, size=cfg.image_size, seed=seed)
        data_s = time.perf_counter() - t0
        last_b, mon_b = _save_bytes(cfg)
        need = 2 * last_b + mon_b  # last, its temporary file during a save, and step_4
        free = shutil.disk_usage(root).free
        log("train_cli_disk", save_last_bytes=last_b, save_monitored_bytes=mon_b, need_bytes=need,
            free_bytes=free, where=root)
        if free < need:
            raise SystemExit(f"chip_smoke: train_cli needs {need} bytes of disk for its checkpoints, "
                             f"{root} has {free} free")
        os.environ.pop("VFACE_PLATFORM", None)  # the CLI's default device: the card
        argv = ["--dataset_dir", data, "--logdir", logdir, "--log_every", "1", "--image_log_every", "2",
                "--ckpt_every", str(TRAIN_CLI_STEPS), "--seed", str(seed)]
        runs = {}
        exit_params = {}  # the first run's model at its exit, copied from the live model on the host
        # the resumed run saves on exit only (each save_last writes ~12 GB)
        for name, extra, steps in (("train", [], TRAIN_CLI_STEPS),
                                   ("resume", ["--resume", "--ckpt_every", str(2 * TRAIN_CLI_RESUME)], TRAIN_CLI_RESUME)):
            restored, built = {}, []

            class CheckedModel(VFaceModel):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    built.append(self)

                def load_params(self, state):
                    # the resumed run's model as loaded, against the first run's model at its exit
                    super().load_params(state)
                    if exit_params:
                        got = self.param_state()
                        restored["equal"] = got.keys() == exit_params.keys() and all(
                            sd.keys() == exit_params[part].keys()
                            and all(torch.equal(v.cpu(), exit_params[part][k]) for k, v in sd.items())
                            for part, sd in got.items())

            tee = _Tee()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee), mock.patch.object(train_driver, "VFaceModel", CheckedModel):
                rc = cli.main(argv + ["--max_steps", str(steps)] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            if rc != 0:
                raise SystemExit(f"chip_smoke: the training CLI's {name} run exited {rc}")
            if not extra:
                exit_params.update({part: {k: v.detach().cpu().clone() for k, v in sd.items()}
                                    for part, sd in built[-1].param_state().items()})
            del built[:]
            torch.cuda.empty_cache()
            out = "".join(tee.parts)
            stages = json.loads(_STAGES.findall(out)[-1])
            with open(os.path.join(logdir, "metrics.jsonl")) as fh:
                recs = [json.loads(line) for line in fh][-steps:]
            terms = {k: [r[k] for r in recs] for k in recs[0] if k.startswith("train/") and k != "train/sec_per_it"}
            clean = [r["train/sec_per_it"] * 1e3 for r in recs if r["step"] in _clean_steps(steps, 2)]
            runs[name] = dict(launches=launches, steps=steps)
            ckdir = os.path.join(logdir, "checkpoints")
            sizes = {n: os.path.getsize(os.path.join(ckdir, n)) for n in sorted(os.listdir(ckdir))}
            files = sorted(os.path.relpath(os.path.join(d, f), logdir) for d, _, fs in os.walk(logdir) for f in fs)
            log("train_cli", run=name, steps=steps, wall_s=f"{wall:.3f}",
                ms_per_step=f"{sum(clean) / len(clean):.1f}" if clean else "n/a",
                ms_steps=",".join(f"{r['train/sec_per_it'] * 1e3:.1f}" for r in recs),
                warmup_and_save_steps_excluded=",".join(str(r["step"]) for r in recs
                                                        if r["step"] not in _clean_steps(steps, 2)),
                peak_gib=f"{peak:.2f}", **{k.split("/")[1]: ",".join(f"{x:.5f}" for x in v) for k, v in terms.items()},
                save_last_s=f"{stages['save_last']['mean_s']:.2f}", save_last_n=stages["save_last"]["count"],
                save_monitored_s=f"{stages.get('save_monitored', {}).get('mean_s', float('nan')):.2f}",
                image_log_s=f"{stages.get('image_log', {}).get('mean_s', float('nan')):.3f}",
                checkpoint_bytes=",".join(f"{n}:{b}" for n, b in sizes.items()), files=",".join(files),
                data_write_s=f"{data_s:.1f}")
            log("train_cli_launches", run=name, **{k: f"{v / steps:g}" for k, v in launches.items() if v},
                note="per step; gn_sums includes the image logs' encode + decode")
            if not all(math.isfinite(x) for v in terms.values() for x in v):
                raise SystemExit(f"chip_smoke: a loss of the training CLI's {name} run is not finite")
            missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
            if missing:
                raise SystemExit(f"chip_smoke: the training CLI's {name} run launched no {missing} kernel")
            if extra:
                start = re.findall(r"\[train\] resumed from step (\d+)", out)
                if not restored.get("equal") or start != [str(TRAIN_CLI_STEPS)]:
                    raise SystemExit("chip_smoke: --resume did not restore the first run's params bit for bit")
                log("train_cli_resume", restored_from_step=start[0], params_bit_equal_to_first_run_exit=restored["equal"],
                    leaves=sum(len(sd) for sd in exit_params.values()))
                exit_params.clear()
            else:
                # the frozen set (VAE, ArcFace, CLIP tower) as the seeded init made it
                init = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), conditioner=True)
                meta = VFaceModel(cfg, device="meta", conditioner=True)
                mask = trainable_mask(meta)
                del meta
                last = torch.load(os.path.join(ckdir, f"step_{TRAIN_CLI_STEPS:08d}"), map_location="cpu",
                                  weights_only=True)["state"]["params"]
                frozen = [n for n, f in mask.items() if not f]
                part = lambda n: ({"conditioner": "cond"}.get(n.split(".")[0], n.split(".")[0]), n.split(".", 1)[1])
                changed = [n for n in frozen if not torch.equal(last[part(n)[0]][part(n)[1]],
                                                                init[part(n)[0]][part(n)[1]].cpu())]
                moved = sum(not torch.equal(last[part(n)[0]][part(n)[1]], init[part(n)[0]][part(n)[1]].cpu())
                            for n, f in mask.items() if f)
                del init, last
                torch.cuda.empty_cache()
                log("train_cli_frozen", frozen_leaves=len(frozen), changed=len(changed), trainable_moved=moved)
                if changed or not moved:
                    raise SystemExit(f"chip_smoke: frozen parameters changed in training ({changed[:5]}) "
                                     f"or no trainable one moved ({moved})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("train_cli_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")
    return runs["train"]


def _seeded_(module, generator):
    """Conv / Dense weights N(0, 1/fan_in), biases N(0, 0.02^2), in place; returns the module."""
    import torch

    from vface_torch.models.layers import Conv, Dense

    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, (Conv, Dense)):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator, device=mod.weight.device)
                                 / math.sqrt(math.prod(mod.weight.shape[1:])))
                if name.startswith("lin"):  # LPIPS's heads weigh squared distances: non-negative
                    mod.weight.abs_()
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator, device=mod.bias.device) * 0.02)
    return module


def _tiny_terms_model(device, params=None):
    """The tiny config at 128^2 (a three-level tiny VAE: LPIPS needs 128^2 for
    its third scale) with its conditioner and a landmark head."""
    import torch

    from vface_torch.models.conditioning import ConditionerConfig
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.models.unet import UNetConfig
    from vface_torch.models.vae import VAEConfig
    from vface_torch.utils.convert import init_params

    cfg = ModelConfig(unet=UNetConfig.tiny(), vae=VAEConfig(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1),
                      cond=ConditionerConfig.tiny(), image_size=128)
    m = VFaceModel(cfg, device=device, conditioner=True, landmark_head=True)
    m.load_params(params or init_params(cfg, torch.Generator().manual_seed(0), conditioner=True, landmark_head=True))
    return m


def phase_train_terms(model, seed: int) -> None:
    """One full-width step (batch 1 at 512^2) with every term the CLI leaves
    off: LPIPS (seeded weights, weight 0.1), the VLB term (1e-3) and a seeded
    landmark head (0.1); then make_split_train_step against the fused step from
    one generator state (UNet gradients within 1e-3 relative L2); then the tiny
    fp32 loss with every term, card against CPU (1e-4)."""
    import dataclasses as dc

    import torch

    from vface_torch.eval.lpips import LPIPS, make_lpips_fn
    from vface_torch.pipelines.train import (
        TrainConfig, make_optimizer, make_split_train_step, make_train_step, p_losses_face, trainable_mask)
    from vface_torch.preprocess.landmarks import UNetLandmarkHead

    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    lp = make_lpips_fn(_seeded_(LPIPS().cuda(), g).state_dict(), device="cuda")
    cfg = TrainConfig(lpips_loss_weight=0.1, original_elbo_weight=1e-3, landmark_loss_weight=0.1)
    model.landmark_head = _seeded_(UNetLandmarkHead(2 * model.cfg.unet.model_channels, model.cfg.latent_size).cuda(), g)
    try:
        # lr 0: AdamW leaves every parameter as it was, so later phases see the same model
        opt, sched = make_optimizer(dc.replace(cfg, learning_rate=0.0), model)
        batch = train_batch(model, 1, seed + 21)
        grads, times = {}, {}
        # timed as the CLI runs; then the gradients compared with cuDNN's
        # deterministic algorithms, twice fused for the run-to-run spread
        runs = (("warmup", make_train_step, False), ("fused", make_train_step, False),
                ("split", make_split_train_step, False), ("fused_det", make_train_step, True),
                ("fused_det_again", make_train_step, True), ("split_det", make_split_train_step, True))
        for name, make, det in runs:
            step = make(model, opt, sched, cfg, lp)
            gen = torch.Generator(device="cuda").manual_seed(seed + 22)
            torch.backends.cudnn.deterministic = det
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            logs = step(batch, gen)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30, kernel_counts(),
                           {k: float(v) for k, v in logs.items()})
            if name != "warmup":
                grads[name] = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
                               if p.grad is not None and n.startswith("unet.")}
            model.zero_grad(set_to_none=True)
        torch.backends.cudnn.deterministic = False
        for name in ("fused", "split"):
            wall, peak, launches, logs = times[name]
            log("train_terms", step=name, ms=f"{wall * 1e3:.1f}", peak_gib=f"{peak:.2f}",
                **{k: f"{v:.6f}" for k, v in logs.items()})
            log("train_terms_launches", step=name, **{k: v for k, v in launches.items() if v})
            if not all(math.isfinite(v) for v in logs.values()) or not {
                    "loss_lpips", "loss_vlb", "loss_landmark", "loss_id", "loss_simple"} <= set(logs):
                raise SystemExit(f"chip_smoke: the {name} step with every term has a missing or non-finite term")
        def rel(a, b):
            ga, gb = grads[a], grads[b]
            if ga.keys() != gb.keys():
                raise SystemExit(f"chip_smoke: the {a} and {b} steps gave gradients to different leaves")
            return (math.sqrt(sum(float((ga[n] - gb[n]).norm()) ** 2 for n in ga))
                    / math.sqrt(sum(float(gb[n].norm()) ** 2 for n in gb)))

        split_det, spread_det, split, spread = (rel("split_det", "fused_det"), rel("fused_det_again", "fused_det"),
                                                rel("split", "fused"), rel("fused_det", "fused"))
        log("train_terms_split", unet_grad_rel_l2=f"{split_det:.3e}", tol=1e-3, deterministic_cudnn=True,
            fused_twice_rel_l2=f"{spread_det:.3e}", default_cudnn_split_rel_l2=f"{split:.3e}",
            default_vs_deterministic_fused_rel_l2=f"{spread:.3e}", leaves=len(grads["fused"]))
        del grads
        if not split_det <= 1e-3:
            raise SystemExit("chip_smoke: the split step's gradients disagree with the fused step's")
    finally:
        model.landmark_head = None
        model.zero_grad(set_to_none=True)
        trainable_mask(model)
        torch.cuda.empty_cache()

    # the tiny fp32 loss with every term: card against CPU (the CPU run is held to JAX by the tests)
    out = {}
    params = None
    for dev in ("cpu", "cuda"):
        m = _tiny_terms_model(dev, params)
        params = params or {k: {n: v.cpu() for n, v in sd.items()} for k, sd in m.param_state().items()}
        trainable_mask(m)
        lpf = make_lpips_fn(_seeded_(LPIPS(), torch.Generator().manual_seed(seed + 23)).state_dict(), device=dev)
        tb = train_batch(m, 2, seed + 24, device="cpu")
        tf = _train_fixed(m, 2, seed + 25, device="cpu")
        tf["drop"] = torch.tensor([True, False])[:, None, None]
        mv = lambda d: {k: v.to(dev) for k, v in d.items()}
        loss, logs = p_losses_face(m, mv(tb), None, dc.replace(cfg, reconstruct_steps=1), mv(tf), perceptual_fn=lpf)
        loss.backward()
        out[dev] = ({k: v.item() for k, v in logs.items()},
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.grad is not None})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    log_err = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    gmax = max(float(v.abs().max()) for v in gc.values())
    ratio = max(float((gg[n] - gc[n]).abs().max()) / (1e-4 * float(gc[n].abs().max()) + 1e-6 * gmax) for n in gc)
    log("train_terms_small_reference", config="tiny fp32 128^2 b2, every term", terms=",".join(sorted(lc)),
        loss_max_rel_err=f"{log_err:.3e}", grad_err_over_tol=f"{ratio:.3f}", tol="1e-4", leaves=len(gc))
    if not (gg.keys() == gc.keys() and log_err <= 1e-4 and ratio <= 1.0 and "loss_lpips" in lc):
        raise SystemExit("chip_smoke: the card's tiny loss with every term disagrees with the CPU's")


VAE_TRAIN_STEPS = 3


def phase_vae_train(model, seed: int) -> None:
    """make_vae_train_step on the SD VAE (the model's seeded weights, copied;
    bf16 compute) at 512^2, batch 1, with a seeded PatchDiscriminator from step
    0 (disc_start 0) and a seeded LPIPS: 3 steps, ms per step after the first,
    peak memory, K3's launches and its gradient path."""
    import torch

    from vface_torch.eval.lpips import LPIPS, make_lpips_fn
    from vface_torch.models.vae import AutoencoderKL
    from vface_torch.ops import gn_sums as GN
    from vface_torch.pipelines.vae_train import PatchDiscriminator, VAELossConfig, make_vae_train_step

    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    vae = AutoencoderKL(model.cfg.vae).cuda()
    vae.load_state_dict(model.vae.state_dict())
    disc = _seeded_(PatchDiscriminator().cuda(), g)
    lp = make_lpips_fn(_seeded_(LPIPS().cuda(), g).state_dict(), device="cuda")
    g_opt = torch.optim.Adam(vae.parameters(), lr=4.5e-6, betas=(0.5, 0.9))  # taming's
    d_opt = torch.optim.Adam(disc.parameters(), lr=4.5e-6, betas=(0.5, 0.9))
    step = make_vae_train_step(vae, disc, g_opt, d_opt, VAELossConfig(disc_start=0), lp)
    img = train_batch(model, 1, seed + 31)["gt_image"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    GN.BACKWARD_CALLS = 0
    times, logs = [], []
    for i in range(VAE_TRAIN_STEPS):
        t0 = time.perf_counter()
        logs.append({k: float(v) for k, v in step(img, i, generator=gen).items()})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, bwd = kernel_counts(), GN.BACKWARD_CALLS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("vae_train", config="SD VAE 512^2 b1 bf16, PatchGAN from step 0, LPIPS", steps=VAE_TRAIN_STEPS,
        ms_per_step=f"{sum(times[1:]) / len(times[1:]) * 1e3:.1f}", ms_steps=",".join(f"{t * 1e3:.1f}" for t in times),
        peak_gib=f"{peak:.2f}", gn_sums_per_step=f"{launches['gn_sums'] / VAE_TRAIN_STEPS:g}",
        gn_sums_backward_per_step=f"{bwd / VAE_TRAIN_STEPS:g}",
        **{k.replace("vae/", ""): ",".join(f"{x[k]:.5f}" for x in logs) for k in logs[0]})
    del vae, disc, lp, g_opt, d_opt, step
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for x in logs for v in x.values()):
        raise SystemExit("chip_smoke: a VAE training loss is not finite")
    if launches["gn_sums"] == 0 or bwd == 0:
        raise SystemExit("chip_smoke: VAE training took no K3 launch or no pass through K3's gradient")


# one fused K2 launch (C = 320, 128-row tiles) through a given library, for racecheck
_ONE_LAUNCH = r"""
import ctypes, sys, torch
lib = ctypes.CDLL(sys.argv[1])
fn = lib.vface_geglu_ff_fused_bf16
fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
g = torch.Generator(device="cuda").manual_seed(0)
m, c, inner = int(sys.argv[2]), 320, 1280
r = lambda *s, k=1.0: (torch.randn(s, generator=g, device="cuda") * k).to(torch.bfloat16)
x, wp, bp, wo, bo = r(m, c), r(2 * inner, c, k=c ** -0.5), r(2 * inner, k=0.1), r(c, inner, k=inner ** -0.5), r(c, k=0.1)
out = torch.empty(m, c, dtype=torch.bfloat16, device="cuda")
err = fn(x.data_ptr(), wp.data_ptr(), bp.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(), m, c, inner, 128,
         torch.cuda.current_stream().cuda_stream)
torch.cuda.synchronize()
assert err == 0, err
torch.save(out.cpu(), sys.argv[3])
"""
_AG_BARRIER = "bar_sync(2 + rw, 128);  // the chunk's whole a*g is in place"
_EPILOGUE = "__nv_bfloat16* hbuf = &sm.h[rw][ch & 1][0][0][0];"


def phase_racecheck() -> None:
    """K2's fused kernel's a*g barrier (the named barrier between a
    warpgroup's epilogue writes of a*g and its second product's reads).
    Builds copies of ``geglu_ff.cu``: one with the barrier removed and the
    epilogue of each warpgroup's last warp delayed 50 us, one with the delay
    alone. A launch of each at C = 320 (M = 4096, 128-row tiles) against the
    shipped kernel: the delay alone must leave the output bit for bit, and
    the phase reports whether the copy without the barrier differs (the check
    fails that copy) or not. Then ``compute-sanitizer --tool racecheck`` on one
    launch of the shipped kernel and of the copy, where the toolkit ships it
    and it runs."""
    import shutil
    import tempfile

    import torch

    from vface_torch.ops import _native

    src = (_native.CSRC / "geglu_ff.cu").read_text()
    if src.count(_AG_BARRIER) != 1 or src.count(_EPILOGUE) != 1:
        raise SystemExit("chip_smoke: racecheck cannot find the a*g barrier or the epilogue in geglu_ff.cu")
    delay = _EPILOGUE + "\n    if (warp == 3) __nanosleep(50000);"
    variants = {"delay": src.replace(_EPILOGUE, delay),
                "no_barrier": src.replace(_EPILOGUE, delay).replace(_AG_BARRIER, "// a*g barrier removed")}
    root = tempfile.mkdtemp(prefix="vface_racecheck_")
    try:
        shutil.copy(_native.CSRC / "hopper.cuh", root)
        procs = {}
        for name, text in variants.items():
            path = os.path.join(root, f"geglu_{name}.cu")
            with open(path, "w") as fh:
                fh.write(text)
            cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", os.path.join(root, f"lib{name}.so"), path]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, proc in procs.items():
            text = proc.communicate()[0].decode(errors="replace")
            if proc.returncode:
                raise SystemExit(f"chip_smoke: racecheck's {name} copy did not build:\n{text[-2000:]}")
        libs = {"shipped": str(_native.lib_path("geglu_ff")),
                **{n: os.path.join(root, f"lib{n}.so") for n in variants}}
        script = os.path.join(root, "one_launch.py")
        with open(script, "w") as fh:
            fh.write(_ONE_LAUNCH)
        outs = {}
        for name, lib in libs.items():
            res = subprocess.run([sys.executable, script, lib, "4096", os.path.join(root, f"{name}.pt")],
                                 capture_output=True, text=True, timeout=120)
            if res.returncode:
                raise SystemExit(f"chip_smoke: racecheck's launch of {name} failed:\n{res.stderr[-2000:]}")
            outs[name] = torch.load(os.path.join(root, f"{name}.pt"))
        delay_equal = torch.equal(outs["delay"], outs["shipped"])
        nb_diff = (outs["no_barrier"].float() - outs["shipped"].float()).abs()
        log("racecheck_delay", delay_alone_bit_equal=delay_equal, no_barrier_bit_equal=bool(nb_diff.max() == 0),
            no_barrier_max_abs_diff=f"{float(nb_diff.max()):.3e}", no_barrier_rows_differ=int((nb_diff.amax(1) > 0).sum()),
            verdict="the copy without the barrier fails" if nb_diff.max() > 0 else "the missing barrier did not show")
        if not delay_equal:
            raise SystemExit("chip_smoke: racecheck's delayed copy changed K2's output: the check itself is broken")
        sanitizer = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
        if not os.path.exists(sanitizer):
            log("racecheck_sanitizer", status="absent", looked_for=sanitizer)
            return
        for name in ("shipped", "no_barrier"):
            try:
                res = subprocess.run([sanitizer, "--tool", "racecheck", "--racecheck-report", "hazard", sys.executable,
                                      script, libs[name], "256", os.path.join(root, f"s_{name}.pt")],
                                     capture_output=True, text=True, timeout=300)
                text = res.stdout + res.stderr
                hazards = re.findall(r"RACECHECK SUMMARY: (\d+) hazard", text)
                lines = [x.strip("= ").strip() for x in text.splitlines() if x.startswith("=========")]
                log("racecheck_sanitizer", copy=name, rc=res.returncode, hazards=hazards[-1] if hazards else "n/a",
                    sanitizer_says=" | ".join(x for x in lines if x)[:1200] or text.strip()[-600:])
            except subprocess.TimeoutExpired:
                log("racecheck_sanitizer", copy=name, status="timed out after 300 s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


IMAGE_BATCH = 4  # the test bench's batch: b = 8 UNet rows under CFG
IMAGE_STEPS = 25  # image and image_cli: cut from the CLIs' 50 steps for time
GUIDED_STEPS, GUIDED_WEIGHT = 10, 0.1  # the guided sampler's depth and gradient weight (b = 1)
IMAGE_FRAME = 1024  # one_inference's full target frame (the background trick and paste-back run at it)
IMAGE_GATE_TOL = 1e-4  # the tiny fp32 image path, card against CPU, of each output's peak (at least 1)


def phase_image_kernels() -> dict:
    """K1, K2 and K9 at the test bench's batch (b = 8: 4 pairs under CFG),
    against their plain versions, timed; returns the rows, which join each
    kernel's row list."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    b = 2 * IMAGE_BATCH
    return {"flash_attention": k1_rows(b, randn), "geglu_ff": ff_rows("geglu_ff", b, randn),
            "geglu_ff_wide": ff_rows("geglu_ff_wide", b, randn)}


def image_inputs(model, n: int, seed: int) -> dict:
    """``n`` seeded target and source faces (``render_face``) at the model's image
    size as the image core takes them: target crops in [-1, 1], keep-masks (1 outside an
    ellipse over the face's landmarks), the masked sources CLIP-normalised,
    the sources in [0, 1] and the targets' landmarks (n, 136), on the card."""
    import numpy as np
    import torch

    from vface_torch.models.clip import clip_preprocess
    from vface_torch.preprocess.synthetic_faces import render_face

    size = model.cfg.image_size
    rng = np.random.default_rng(seed)
    faces = [render_face(rng, size) for _ in range(2 * n)]
    yy, xx = np.mgrid[:size, :size].astype(np.float32)

    def keep(lm):
        (x0, y0), (x1, y1) = lm.min(axis=0), lm.max(axis=0)
        face = (((xx - (x0 + x1) / 2) / (0.6 * (x1 - x0) + 1)) ** 2
                + ((yy - (y0 + y1) / 2) / (0.6 * (y1 - y0) + 1)) ** 2) <= 1.0
        return (~face).astype(np.float32)[..., None]

    on = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).cuda()
    tar01, tar_lm = on([f[0] for f in faces[:n]]), on([f[1] for f in faces[:n]])
    src01 = on([f[0] for f in faces[n:]])
    tar_keep, src_keep = on([keep(f[1]) for f in faces[:n]]), on([keep(f[1]) for f in faces[n:]])
    return dict(target=tar01 * 2 - 1, keep=tar_keep, src_clip=clip_preprocess(src01 * (1 - src_keep),
                model.cfg.cond.clip.image_size), src01=src01, lms=tar_lm.reshape(n, 136))


def phase_image(model, seed: int) -> None:
    """Phase image on the video phase's model (bf16, with the conditioner):
    the REFace image core and its samplers at 512^2, seeded weights and faces.

    A warm-up (2 steps) of ``swap_image_batch`` at b = 4 and of
    ``one_inference``'s ``swap_one`` at b = 1 on a ``IMAGE_FRAME``^2 frame
    (its background trick and paste-back at the full frame) holds every K1,
    K2, K9 and K3 call at their new signatures to its plain version. Then,
    each with the counts set to 0 before it and read after: (1)
    ``swap_image_batch`` at b = 4, ``IMAGE_STEPS`` steps, scale 3.0: seconds
    per stage (conditioning, encode, sample, decode), peak memory, launches;
    (2) ``plms_sample`` on the same conditioning, ``IMAGE_STEPS`` steps: UNet
    evals per step and seconds; (3) ``ddim_sample_guided`` at b = 1 with
    ``id_dir_scaling`` and ``grad_weight`` ``GUIDED_WEIGHT``, ``GUIDED_STEPS``
    steps: seconds a step, peak memory, K3's forward launches and its VJP's
    passes, every ID gradient finite and non-zero. Gated: finite outputs of
    the expected shapes in their ranges, every kernel of the path launched,
    two evals in the first PLMS step and one in each other. Then
    :func:`phase_image_gate`."""
    import numpy as np
    import torch

    from vface_torch.models.clip import clip_preprocess
    from vface_torch.ops import gn_sums as GN
    from vface_torch.ops.warp import resize_bilinear
    from vface_torch.pipelines.image_swap import ImageSwapOptions, swap_image_batch
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.preprocess.synthetic_faces import render_face
    from vface_torch.samplers import guided
    from vface_torch.samplers.ddim import seeded_noise
    from vface_torch.samplers.plms import plms_sample
    from vface_torch.scripts.one_inference import swap_one
    from vface_torch.utils.convert import init_aux_params

    t_phase = time.perf_counter()
    b, hl = IMAGE_BATCH, model.cfg.latent_size
    x = image_inputs(model, b, seed + 40)
    args = [x[k] for k in ("target", "keep", "src_clip", "src01", "lms")]
    aux = init_aux_params(torch.Generator(device="cuda").manual_seed(seed + 41))
    pipe = VideoSwapPipeline(model, SwapOptions(image_size=model.cfg.image_size, parser_size=512), device="cuda",
                             aux_params={k: aux[k] for k in ("bisenet", "landmark")})
    rng = np.random.default_rng(seed + 42)
    s = model.cfg.image_size
    frame, src_face = render_face(rng, IMAGE_FRAME)[0], render_face(rng, s)[0]
    t0 = time.perf_counter()
    with checked_sites("image"):
        swap_image_batch(model, *args, ImageSwapOptions(2, 3.0))
        one = swap_one(pipe, frame, src_face, ImageSwapOptions(2, 3.5))
    torch.cuda.synchronize()
    log("image_warmup", ddim_steps=2, batch=b, one_inference_frame=f"{IMAGE_FRAME}^2",
        wall_s=f"{time.perf_counter() - t0:.3f}")
    if not (one.shape == (IMAGE_FRAME, IMAGE_FRAME, 3) and np.isfinite(one).all()):
        raise SystemExit("chip_smoke: one_inference's swap_one gave the wrong shape or non-finite values")

    def measured(name, fn, expect=SWAP_KERNELS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        GN.BACKWARD_CALLS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        missing = [k for k in expect if launches[k] == 0]
        stray = [k for k in launches if k not in SWAP_KERNELS and launches[k]]
        if missing or stray:
            raise SystemExit(f"chip_smoke: the image path's {name} launched no {missing} / stray {stray} kernels")
        return out, wall, launches, torch.cuda.max_memory_allocated() / 2**30

    timings = {}
    out, wall, launches, peak = measured("swap", lambda: swap_image_batch(
        model, *args, ImageSwapOptions(IMAGE_STEPS, 3.0), timings=timings))
    ok = tuple(out.shape) == (b, s, s, 3) and bool(torch.isfinite(out).all()) and 0 <= float(out.min()) \
        and float(out.max()) <= 1
    log("image_swap", batch=b, unet_batch=2 * b, ddim_steps=IMAGE_STEPS, scale=3.0, wall_s=f"{wall:.3f}",
        s_per_pair=f"{wall / b:.3f}", **stage_line(timings), peak_gib=f"{peak:.2f}",
        **{k: v for k, v in launches.items() if v})
    if not ok:
        raise SystemExit("chip_smoke: the image swap's output has the wrong shape, is not finite or leaves [0, 1]")

    with torch.inference_mode():
        tar_clip = clip_preprocess((x["target"] + 1) * 0.5, model.cfg.cond.clip.image_size)
        cond = model.conditioning(x["src_clip"], x["lms"], tar_clip, x["src01"])
        uncond = model.uncond(b)
        z_inpaint = model.encode_first_stage(x["target"] * x["keep"])
        mask_lat = resize_bilinear(x["keep"], hl, hl)
        x_T = seeded_noise("cuda", 42)(0, (b, hl, hl, 4))
    evals = []
    real = model.apply_model

    def counted(*a, **k):
        evals.append(a[0].shape[0])
        return real(*a, **k)

    model.apply_model = counted
    try:
        with torch.inference_mode():
            (z0, traj), wall, launches, peak = measured("plms", lambda: plms_sample(
                model, x_T, cond, uncond, z_inpaint, mask_lat, num_steps=IMAGE_STEPS, cfg_scale=3.0),
                expect=("flash_attention", "geglu_ff", "geglu_ff_wide"))
    finally:
        del model.apply_model
    log("image_plms", batch=b, steps=IMAGE_STEPS, evals=len(evals), evals_first_step=2,
        evals_per_step=f"{len(evals) / IMAGE_STEPS:.3f}", eval_batch=evals[0], wall_s=f"{wall:.3f}",
        s_per_step=f"{wall / IMAGE_STEPS:.4f}", peak_gib=f"{peak:.2f}", **{k: v for k, v in launches.items() if v})
    if not (len(evals) == IMAGE_STEPS + 1 and set(evals) == {2 * b} and bool(torch.isfinite(z0).all())
            and tuple(traj.shape) == (IMAGE_STEPS, b, hl, hl, 4)):
        raise SystemExit(f"chip_smoke: PLMS ran {len(evals)} evals for {IMAGE_STEPS} steps or gave non-finite latents")

    grads = []
    real_grad = guided.id_loss_grad

    def spied(*a, **k):
        g = real_grad(*a, **k)
        grads.append((bool(torch.isfinite(g).all()), float(g.abs().max())))
        return g

    with torch.inference_mode():
        src_emb = guided.safe_l2_normalize(model.conditioner.arcface(
            guided.arcface_preprocess(x["src01"][:1] * (1 - x["keep"][:1]))))
    src_emb = src_emb.clone()
    guided.id_loss_grad = spied
    try:
        (zg, _), wall, launches, peak = measured("guided", lambda: guided.ddim_sample_guided(
            model, x_T[:1].clone(), cond[:1].clone(), uncond[:1].clone(), z_inpaint[:1].clone(),
            mask_lat[:1].clone(), src_emb, x["keep"][:1], num_steps=GUIDED_STEPS, cfg_scale=3.0,
            id_dir_scaling=True, grad_weight=GUIDED_WEIGHT))
    finally:
        guided.id_loss_grad = real_grad
    bwd = GN.BACKWARD_CALLS
    log("image_guided", batch=1, steps=GUIDED_STEPS, grad_weight=GUIDED_WEIGHT, id_dir_scaling=True,
        wall_s=f"{wall:.3f}", s_per_step=f"{wall / GUIDED_STEPS:.4f}", peak_gib=f"{peak:.2f}",
        gn_sums_forward=launches["gn_sums"], gn_sums_backward_passes=bwd,
        grad_abs_max=",".join(f"{m:.3e}" for _, m in grads), **{k: v for k, v in launches.items() if v})
    if not (len(grads) == GUIDED_STEPS and all(f and m > 0 for f, m in grads) and bwd > 0
            and bool(torch.isfinite(zg).all())):
        raise SystemExit("chip_smoke: the guided sampler's ID gradient was not finite and non-zero at every "
                         "step, or K3's backward did not run")
    del out, z0, traj, zg
    torch.cuda.empty_cache()
    phase_image_gate(seed)
    log("image_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


def phase_image_gate(seed: int) -> None:
    """The tiny fp32 image path (seeded, its conditioner included) on the card
    against the same calls on the CPU (which the tests hold to the JAX
    package): ``swap_image_batch`` (an explicit x_T), ``plms_sample``,
    ``ddim_sample_guided`` with both mechanisms, a 3-chunk UNet eval with the
    conv injection, and in each of the "concat", "stack" and "sep_head"
    modes the conditioner's tokens and a UNet eval on [uncond, cond]; each
    output within ``IMAGE_GATE_TOL`` of its peak (at least 1)."""
    import torch

    from vface_torch.models.clip import clip_preprocess
    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.models.unet import InjectionSpec
    from vface_torch.pipelines.image_swap import ImageSwapOptions, swap_image_batch
    from vface_torch.samplers.guided import ddim_sample_guided
    from vface_torch.samplers.plms import plms_sample
    from vface_torch.utils.convert import init_params

    base = ModelConfig.tiny(image_size=32)
    b, s, hl, d, steps = 2, 32, base.latent_size, base.unet.context_dim, 4
    g = torch.Generator().manual_seed(seed + 50)
    r = lambda *shape: torch.randn(shape, generator=g)
    keep = torch.ones(b, s, s, 1)
    keep[:, 8:26, 6:24] = 0.0
    emb = r(b, 512)
    x = dict(target=torch.rand(b, s, s, 3, generator=g) * 2 - 1, keep=keep, src_clip=r(b, s, s, 3),
             src01=torch.rand(b, s, s, 3, generator=g), lms=torch.rand(b, 136, generator=g) * s, x_T=r(b, hl, hl, 4),
             cond=r(b, 1, d), uncond=r(b, 1, d), inpaint=r(b, hl, hl, 4), mask=(r(b, hl, hl, 1) > 0).float(),
             emb=emb / emb.norm(dim=-1, keepdim=True), x9=r(3 * b, hl, hl, 9), ctx=r(3 * b, 1, d))
    ts = torch.tensor([900, 500, 100] * b)[:3 * b]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = VFaceModel(base, device=dev, conditioner=True)
        model.load_params(init_params(base, torch.Generator().manual_seed(seed + 51), conditioner=True))
        v = {k: t.to(dev) for k, t in x.items()}
        res = {"swap": swap_image_batch(model, v["target"], v["keep"], v["src_clip"], v["src01"], v["lms"],
                                        ImageSwapOptions(steps, 3.0, s), noise=lambda i, shape: v["x_T"])}
        with torch.inference_mode():
            res["plms_z0"], res["plms_traj"] = plms_sample(model, v["x_T"], v["cond"], v["uncond"], v["inpaint"],
                                                           v["mask"], num_steps=steps)
            res["conv_inject"] = model.apply_model(v["x9"], ts.to(dev), v["ctx"],
                                                   injection=InjectionSpec(chunks=3, conv_inject=True))
        res["guided_z0"], res["guided_traj"] = ddim_sample_guided(
            model, v["x_T"], v["cond"], v["uncond"], v["inpaint"], v["mask"], v["emb"], v["keep"], num_steps=steps,
            id_dir_scaling=True, grad_weight=0.5)
        for mode in ("concat", "stack", "sep_head"):
            cfg = dataclasses.replace(base, cond=dataclasses.replace(base.cond, mode=mode))
            mm = VFaceModel(cfg, device=dev, conditioner=True)
            mm.load_params(init_params(cfg, torch.Generator().manual_seed(seed + 52), conditioner=True))
            with torch.inference_mode():
                tar_clip = clip_preprocess(v["target"] * 0.5 + 0.5, cfg.cond.clip.image_size)
                c = mm.conditioning(v["src_clip"], v["lms"], tar_clip, v["src01"])
                ctx = torch.cat([mm.uncond(b), c])
                res[f"{mode}_cond"] = c
                res[f"{mode}_unet"] = mm.apply_model(v["x9"][:2 * b], ts[:2 * b].to(dev), ctx)
        outs[dev] = {k: t.detach().cpu() for k, t in res.items()}
    err = {k: float((outs["cuda"][k] - outs["cpu"][k]).abs().max()) for k in outs["cpu"]}
    peak = {k: max(1.0, float(outs["cpu"][k].abs().max())) for k in outs["cpu"]}
    log("image_gate", config=f"tiny fp32, b = {b}, {steps} steps", **{f"{k}_max_abs": f"{e:.3e}" for k, e in err.items()},
        **{f"{k}_peak": f"{peak[k]:.3f}" for k in err}, tol=f"{IMAGE_GATE_TOL} of the peak")
    if not all(err[k] <= IMAGE_GATE_TOL * peak[k] for k in err):
        raise SystemExit("chip_smoke: the card's tiny image path, conv injection or token modes disagree with "
                         "the CPU's")


def flax_npz_arrays(prefix: str, state: dict) -> dict:
    """A module's state dict as the flat ``<prefix>/<Flax path>`` arrays of a JAX
    params npz (``save_params_npz``'s layout): Dense and Conv ``weight`` ->
    ``kernel`` (transposed to (in, out) / HWIO), a norm's 1-D ``weight`` ->
    ``scale``, the rest as they are."""
    out = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        a = value.detach().float().cpu().numpy()
        if leaf == "weight" and a.ndim in (2, 4):
            leaf, a = "kernel", (a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0))
        elif leaf == "weight":
            leaf = "scale"
        out["/".join([prefix, *mods, leaf])] = a
    return out


def run_image_cli(module, argv: list) -> dict:
    """An image CLI's ``main(argv)`` in process on the card, its output kept;
    returns {"wall_s", "peak_gib", "out"}. A non-zero return fails the script."""
    import torch

    tee = _Tee()
    os.environ.pop("VFACE_PLATFORM", None)  # the CLIs' default device: the card
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"chip_smoke: {module.__name__} {' '.join(argv)} exited {rc}")
    return {"wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "out": "".join(tee.parts)}


def phase_image_cli(seed: int) -> None:
    """Phase image_cli: both image CLIs in process through ``main(argv)`` at
    their defaults but for the depth (``IMAGE_STEPS`` steps; SD-v1
    inpainting with its conditioner, seeded by each CLI), on inputs the
    script writes to a temporary directory with ``write_synthetic_celeba``
    (512^2 renders with class maps) and ``render_face``:
    ``inference_test_bench`` on 4 pairs (one batch; 4 PNGs of 512^2);
    ``one_inference`` on one ``IMAGE_FRAME``^2 target with ``--watermark``
    (the payload read back from the saved PNG); with ``--safety_params`` from a
    seeded checker (the ViT-L/14 tower at random, thresholds that flag
    everything: the output black); the folder mode, 2 targets x 1 source (two
    files with the JAX CLI's names). Each run's wall seconds and peak memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vface_torch.data.datasets import write_synthetic_celeba
    from vface_torch.io.image import read_png, write_png
    from vface_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
    from vface_torch.preprocess.synthetic_faces import render_face
    from vface_torch.scripts import inference_test_bench, one_inference
    from vface_torch.utils.watermark import DEFAULT_PAYLOAD, extract_watermark

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vface_image_cli_")
    try:
        write_synthetic_celeba(os.path.join(root, "src"), 4, size=512, seed=seed + 60)
        write_synthetic_celeba(os.path.join(root, "tar"), 4, size=512, seed=seed + 61)
        bench_out = os.path.join(root, "bench")
        run = run_image_cli(inference_test_bench, [
            "--src_dir", os.path.join(root, "src", "CelebA-HQ-img"),
            "--tar_dir", os.path.join(root, "tar", "CelebA-HQ-img"),
            "--mask_dir", os.path.join(root, "tar", "Overall_mask"), "--outdir", bench_out,
            "--ddim_steps", str(IMAGE_STEPS)])
        pngs = sorted(os.listdir(bench_out))
        shapes = {read_png(os.path.join(bench_out, p)).shape for p in pngs}
        log("image_cli_bench", pairs=4, batch=4, ddim_steps=IMAGE_STEPS, wall_s=f"{run['wall_s']:.3f}",
            peak_gib=f"{run['peak_gib']:.2f}", pngs=",".join(pngs))
        if len(pngs) != 4 or shapes != {(512, 512, 3)} or "saved 4 swapped images" not in run["out"]:
            raise SystemExit(f"chip_smoke: the test bench wrote {pngs} of {shapes}")

        rng = np.random.default_rng(seed + 62)
        u8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)
        for d in ("targets", "sources"):
            os.makedirs(os.path.join(root, d))
        for i in range(2):
            write_png(os.path.join(root, "targets", f"frame{i}.png"), u8(render_face(rng, IMAGE_FRAME)[0]))
        write_png(os.path.join(root, "sources", "me.png"), u8(render_face(rng, 512)[0]))
        tar, src = os.path.join(root, "targets", "frame0.png"), os.path.join(root, "sources", "me.png")
        common = ["--ddim_steps", str(IMAGE_STEPS)]
        out = os.path.join(root, "marked.png")
        run = run_image_cli(one_inference, ["--target", tar, "--source", src, "--out", out, "--watermark", *common])
        img = read_png(out)
        payload = extract_watermark(img)
        log("image_cli_one", mode="single", watermark=True, wall_s=f"{run['wall_s']:.3f}",
            peak_gib=f"{run['peak_gib']:.2f}", shape=img.shape, payload=payload.decode(errors="replace"))
        if img.shape != (IMAGE_FRAME, IMAGE_FRAME, 3) or payload != DEFAULT_PAYLOAD:
            raise SystemExit(f"chip_smoke: one_inference wrote {img.shape}, payload {payload!r}")

        width = CLIPVisionConfig().width
        with torch.device("cuda"):
            tower = CLIPVisionTower(CLIPVisionConfig())
        g = torch.Generator(device="cuda").manual_seed(seed + 63)
        with torch.no_grad():
            for p in tower.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
        sr = np.random.default_rng(seed + 64)
        safety = {**flax_npz_arrays("clip", tower.state_dict()),
                  "visual_projection": (sr.normal(size=(width, 768)) / math.sqrt(width)).astype(np.float32),
                  "concept_embeds": sr.normal(size=(17, 768)).astype(np.float32),
                  "concept_thresholds": np.full(17, -2.0, np.float32),  # every cosine passes: flagged
                  "special_care_embeds": sr.normal(size=(3, 768)).astype(np.float32),
                  "special_care_thresholds": np.full(3, 2.0, np.float32)}
        del tower
        np.savez(os.path.join(root, "safety.npz"), **safety)
        del safety
        out = os.path.join(root, "checked.png")
        run = run_image_cli(one_inference, ["--target", tar, "--source", src, "--out", out, "--safety_params",
                                            os.path.join(root, "safety.npz"), *common])
        img = read_png(out)
        log("image_cli_one", mode="single", safety=True, wall_s=f"{run['wall_s']:.3f}",
            peak_gib=f"{run['peak_gib']:.2f}", flagged="[safety]" in run["out"], black=not img.any())
        if img.any() or "[safety]" not in run["out"]:
            raise SystemExit("chip_smoke: the flagged one_inference output is not black")

        folder = os.path.join(root, "folder")
        run = run_image_cli(one_inference, ["--target", os.path.join(root, "targets"), "--source",
                                            os.path.join(root, "sources"), "--out", folder, *common])
        names = sorted(os.listdir(folder))
        log("image_cli_one", mode="folder", targets=2, sources=1, wall_s=f"{run['wall_s']:.3f}",
            peak_gib=f"{run['peak_gib']:.2f}", files=",".join(names))
        if names != ["me_to_frame0.png", "me_to_frame1.png"]:
            raise SystemExit(f"chip_smoke: one_inference's folder mode wrote {names}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("image_cli_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


def kernels_line(rows: dict, launches: dict) -> dict:
    """One entry per kernel: the ds1 / largest site's numbers at top level, every site under "sites".

    ``launches`` is each kernel's count over its main path's run (K1-K3 and K9
    the swap window, K4-K6 the timed train steps, K7-K8 the ops phase, K10-K13
    the bench phase, the fp32 forms of K5, K2 and K9 the fp32 UNet's eval and
    loss + backward), or the rows' own counts where they carry one (K13 on
    fp32: its timed calls); K5's two kernels launch together, and its entries
    carry the dQ kernel's count."""
    out = []
    for name, sites in rows.items():
        head = dict(sites[0])
        head["max_abs_err"] = max(r["max_abs_err"] for r in sites)
        head["launches"] = (sum(r["launches"] for r in sites) if "launches" in sites[0]
                            else launches[name.replace("_bwd", "_bwd_dq", 1)])
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
    t_script = time.perf_counter()

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
    for name, more in phase_sched_kernels().items():  # K1, K2, K9 at the schedulers' batches
        rows[name] += more
    for name, more in phase_image_kernels().items():  # and at the image test bench's
        rows[name] += more
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
    base = phase_sched(model, SEED)
    torch.cuda.empty_cache()
    phase_opts(model, SEED, base)
    torch.cuda.empty_cache()
    phase_multiface(model, SEED, base)
    del base
    torch.cuda.empty_cache()
    phase_image(model, SEED)
    torch.cuda.empty_cache()
    train_launches = phase_train(model, SEED)
    phase_train_reference(model, SEED)
    if args.profile_train:
        phase_profile_train(model, SEED, args.profile_train)
    phase_train_terms(model, SEED)
    phase_vae_train(model, SEED)
    del model  # the training CLI, the fp32 gate and the video CLI build their own models
    torch.cuda.empty_cache()
    phase_train_cli(SEED)
    phase_racecheck()
    phase_sched_gate(SEED)
    phase_cli(SEED)
    phase_image_cli(SEED)
    launches.update({k: v for k, v in train_launches.items() if k not in SWAP_KERNELS})
    launches.update({k: ops_launches[k] for k in OPS_KERNELS})
    launches.update({k: bench_launches[k] for k in BENCH_KERNELS})
    launches.update({k: f32_launches[k] for k in ("flash_attention_bwd_dq_f32", "geglu_ff_f32", "geglu_ff_wide_f32")})
    log("script", wall_s=f"{time.perf_counter() - t_script:.1f}")
    print(smi, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
