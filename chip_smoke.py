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
     and IRSE50 in the conditioner: one warm-up step and 3 timed steps (cut
     from 5 for time), ms per
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
     class maps): 3 steps (log_every 1, image_log_every 2, ckpt_every 3: one
     save, cut from two for time, and from 4 steps; the ``--resume`` run that followed is cut
     for time and disk writes, and mesh_train reads a ``last`` back instead): ms per
     step (the first step and those after an image log or a save left out),
     peak memory, the loss terms, launches per step, checkpoint bytes and
     seconds per save, the files written; the disk a save needs (from the
     state's numel) against what the temporary directory has; frozen
     parameters as the seeded init made them;
 10e. racecheck: K2's fused kernel's a*g barrier: copies of ``geglu_ff.cu``
     without it (and one warp's epilogue delayed) and with the delay alone
     (built beside the kernels in phase build), against the shipped kernel,
     one launch each at once; ``compute-sanitizer --tool racecheck`` where
     the toolkit ships it;
 11. (``--profile PATH``, ``--profile-train PATH``) CUDA time by kernel of one
     sampling UNet eval (and the device time of its feed-forwards: K2's sites,
     the wide sites on K9, and the rest), of one train step;
 11b. sched (the window schedules of the video path; ``phase_sched_kernels``
     adds K1, K2 and K9 rows at b = 18 and 24 to the kernels phase): (b) on
     the video phase's model, a seeded 12-frame 720x1280 clip at the
     reference operating point but for the depth (8 + 8 steps, cut for
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
     merged sampling at 2 and the loop at eta = 0.5 (sched's 8 + 8): seconds,
     frames/s, invert and sample seconds, K1/K2/K9 launches (the cached runs
     gated to fewer K1s than the exact run), peak memory, the uint8 difference
     (reported); then the tiny fp32 samplers with the cache, eta (an explicit
     noise stack), ``src_start`` and inversion CFG on the card against the CPU
     within 1e-4;
 11d. multiface: a seeded 720^2 two-face ``render_scene`` rolled over 12
     frames; the face detector (shipped weights) on the card against the CPU
     (boxes 0.5 px, scores 1e-4, every face found in every frame), then
     ``swap_video_frames_multiface`` at the reference operating point but for
     the depth (8 + 8 steps): seconds (per face), frames/s, peak memory,
     launches;
 11f. dift_vq (``phase_dift_kernels`` adds K1, K2 and K9 rows at b = 2 and
     K3 rows at DIFT's bf16 and VQ's fp32 VAE shapes to the kernels phase):
     ``make_prior`` (DIFT) at 512^2 on the video phase's bf16 model, every
     K1, K2, K9 and K3 call of a warm-up held to its plain version, then
     one timed call between a counter reset and a read (seconds, peak
     memory, launches, each of the four launched), its features within
     3e-2 relative L2 of the plain path's and the share of equal
     correspondences; ``VQModel(VQConfig())`` (fp32, seeded) on one 512^2
     image: seconds, peak memory, K3's launches; the tiny fp32 DIFT and VQ,
     card against CPU within 1e-4;
 11g. aux_clis: ``CLIPTextEncoder(CLIPTextConfig())`` (fp32) on a 2 x 77
     batch from the port's tokenizer (synthetic vocabulary), card against
     CPU within 1e-4; the ``driven_demo`` CLI at ``FV2VConfig()`` on an
     8-frame 256^2 Y4M with a seeded ``--params`` npz (seconds a frame, peak
     memory) and one generator frame card against CPU within 1e-4;
     ``crop_and_mask`` on 4 rendered 1024^2 faces at ``--size 512``, card
     against CPU: masks equal but at class ties (top two logits within
     1e-3), crops within 1 uint8 level;
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
     conditioner, seeded; 8 + 8 steps, cut for time; window 6, scale 3.0,
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
 12c. eval (after multiface, on its own seeded nets): ``evaluate_all`` on
     16 ``render_face`` images a directory at full size (InceptionV3's
     pool3 with He kernels, IR-SE-50, Hopenet, the 3DMM regressor; perturbed
     frozen-BN statistics): seconds per metric, peak memory; 4 images' features
     from each net, card against CPU, within 1e-4 of their peak with TF32
     switched on around the card's call; ``evaluate_temporal`` on the sched
     phase's sequential swap at 360x640 with RAFT's flow;
 12d. mesh_gate (after sched (a)): two ranks, spawned (NCCL on two cards
     where the host has them, else gloo with both on card 0), the fp32
     gate's model and depth: the frame-sharded swap (window 6, 3 frames a
     rank, the FGATS halo) and the window-parallel swap (2 full windows and
     a short one) each within 1e-3 of the sequential loop, and the
     frame-sharded swap with each rank's halo replaced by its own first
     frame missing that limit; backend, world size, seconds and peak memory
     a rank;
 12e. mesh_train: ``train(n_data=2)`` at full width, batch 1 a rank, 2 steps,
     ZeRO-1, cuDNN deterministic: the first step's averaged UNet gradients
     within 1e-5 relative L2 of the same two rows computed at batch 1 on one
     process, and as far from the one-rank step on the global batch of 2 as
     the batch shape alone moves it (1.25x); the params after 2 steps within
     1e-3 relative L2 of the one-rank run's; each rank's optimizer state
     about half the one-rank total; ``last`` read back as a one-rank resume
     reads it;
 12f. mesh_cli (inside cli): the video CLI under ``torchrun --standalone
     --nproc_per_node 1`` with ``--mesh_data 1`` and with ``--mesh_frames 1``
     on pair A, the two at once, its frames against run A's (1 level in the
     PNGs, 2 in the Y4M), frames/s and peak memory;
 12g. hires (after image, on its model; ``phase_hires_kernels`` adds the
     attention kernels' rows at ds4's head width 160 to the kernels phase: K1
     at (2, 1024), (8, 1024), (6, 576), (12, 576); K4, K6, K5 at (1, 576)
     and (1, 1024); K7 at (1, 1024); K8, K4, K6 and K7 on fp32 at (1, 1024)
     and (12, 576), equal bit for bit; K5 on fp32 at (1, 576) and (1, 1024)): SD-v1
     above 512^2, where the ds4 self-attention takes the kernels at dh 160,
     counts reset before each run and launches at dh 160 read after it:
     ``swap_image_batch`` at 1024^2, b = 1, 10 steps, against the plain
     versions within 3e-2 relative L2; ``swap_window`` on 6 frames at 768^2,
     8 + 8 steps, every kernel call site held to its plain version; one bf16
     train step at 768^2 (b = 1; it peaks near 58 GiB, and 1024^2's 1.8x the
     pixels would pass 80 GB), its UNet
     gradients within 3e-2 of the plain path's; and, in phase fp32_unet,
     one fp32 UNet eval at 768^2 (b = 2) and one fp32 loss + backward there
     (b = 1, K5's fp32 kernels at dh 160), each within 1e-3 of the plain
     path; seconds, peak memory;
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
import importlib
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
    _RACECHECK_BUILDS["builds"] = _start_racecheck_builds()
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
    log("k1_dynamic_smem", **{f"dh{dh}_nc{nc}": smem(dh, nc) for dh in (8, 40, 80, 160) for nc in (2, 3)})
    smem = _native.function("flash_attention_bwd", "vface_flash_attention_bwd_smem_bytes", [ctypes.c_int])
    log("k5_dynamic_smem", **{f"dh{dh}": smem(dh) for dh in (8, 40, 80, 160)})
    smem = _native.function("flash_attention_f32", "vface_flash_attention_f32_smem_bytes", [ctypes.c_int])
    log("k8_dynamic_smem", **{f"dh{dh}": smem(dh) for dh in (16, 32, 40, 80, 160)})
    smem = _native.function("geglu_ff", "vface_geglu_ff_smem_bytes", [ctypes.c_int] * 3)
    log("geglu_dynamic_smem", **{f"fused_c{c}_tm{tm}": smem(c, tm, 0) for c, tm in ((64, 128), (320, 64), (320, 128))},
        **{f"gemm{gm}": smem(0, 128, gm) for gm in (1, 2)})
    smem = _native.function("flash_attention_bwd_f32", "vface_flash_attention_bwd_f32_smem_bytes", [ctypes.c_int] * 2)
    log("k5_f32_dynamic_smem", **{f"dh{dh}_{k}": smem(dh, i) for dh in (16, 32, 40, 80, 160)
                                   for i, k in enumerate(("dq", "dkv"))})
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


def k1_rows(batch: int, randn, sites=((4096, 320), (1024, 640))) -> list:
    """K1 at ``batch`` at the self-attention sites ``sites`` ((tokens, channels),
    8 heads; by default ds1, dh 40, and ds2, dh 80): its rows (the library
    column is SDPA)."""
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

    out = []
    for n, c in sites:
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
    # cluster of 8 CTAs each)
    rows["gn_sums"] = [gn_row(randn(vae_batch, c, hh, ww))
                       for c, hh, ww in ((128, 512, 512), (512, 128, 128), (128, 720, 1280))]
    return rows


def gn_row(x, **extra) -> dict:
    """K3's row on ``x`` (NCHW; a float32 ``x`` is marked so in the shape):
    against its plain version, timed (the event time holds the wrapper's host
    time, ``device_ms`` the kernel's alone); the library column is
    ``torch.var_mean``."""
    import torch

    from vface_torch.ops import gn_sums as GN

    b, c, hh, ww = x.shape
    errs, tol = kernel_errs("gn_sums", (x,), GN.gn_sums(x))
    bnd = bound(2.0 * x.numel(), x.numel() * x.element_size() + 2 * b * c * 4, PEAK_FP32_FLOPS)
    dev_ms = device_ms(lambda: GN.gn_sums(x), "gn_sums")
    return _row("gn_sums", "cuda", "vface_torch/csrc/gn_sums.cu", "vface_tpu/models/layers.py:45", errs, tol,
                cuda_ms(lambda: GN.gn_sums(x)), cuda_ms(lambda: GN.gn_sums_ref(x)),
                cuda_ms(lambda: torch.var_mean(x, dim=(2, 3))), bnd,
                f"({b},{c},{hh},{ww}){'fp32' if x.dtype == torch.float32 else ''}",
                extra={**extra, "device_ms": f"{dev_ms:.4f}"})


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

    FA.DH_LAUNCHES.clear()
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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    rows = {"flash_attention_stats": [], "flash_attention_bwd": [], "flash_attention_fp32": []}
    for nq, nk, c in ((4096, 4096, 320), (1024, 1024, 640), (RAGGED_NQ, RAGGED_NK, 320)):
        _train_rows(rows, 1, nq, nk, c, 8, randn)
    return rows


def _train_rows(rows: dict, b: int, nq: int, nk: int, c: int, h: int, randn) -> None:
    """K4 (where Nq = Nk), K6 and K5 at (b, nq over nk, c) with h heads on
    bf16 ``randn`` inputs, gated as :func:`phase_train_kernels` says; their
    rows go into ``rows``."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

    fwd_src = "vface_torch/csrc/flash_attention.cu"
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

    from vface_torch.ops import geglu_ff as FF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    rows = {"flash_attention_bwd_f32": [], "geglu_ff_f32": [], "geglu_ff_wide_f32": []}
    for nq, nk, c in ((4096, 4096, 320), (1024, 1024, 640), (RAGGED_NQ, RAGGED_NK, 320)):
        _bwd_f32_row(rows, 1, nq, nk, c, 8, randn)

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


def _bwd_f32_row(rows: dict, b: int, nq: int, nk: int, c: int, h: int, randn) -> None:
    """K5 on fp32 at (b, nq over nk, c), h heads, on fp32 ``randn`` inputs,
    gated as :func:`phase_f32_kernels` says; its row goes into ``rows``."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

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


def _k7_bf16_row(rows: dict, b: int, nq: int, nk: int, c: int, h: int, randn) -> None:
    """K7 at bf16 (K6's kernel with the stats epilogue) at (b, nq over nk, c),
    h heads, on bf16 ``randn`` inputs, gated as :func:`phase_ops_kernels`
    says (output equal to K6's bit for bit, m and l within 1e-5 relative, 2
    bf16 ulps, the precision gate); its row goes into ``rows``."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

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
        raise SystemExit(f"chip_smoke: flash_attention_v2_stats's m/l disagree or its output is not K6's at {shape}")
    precision_gate("flash_attention_v2_stats", shape, out, want, FA.flash_attention_stats_ref(q, k, v, h)[0])
    split = lambda t: t.view(b, -1, h, dh).transpose(1, 2).float()
    qf, kf, vf = split(q), split(k), split(v)
    rows["flash_attention_v2_stats"].append(_row(
        "flash_attention_v2_stats", "cuda", "vface_torch/csrc/flash_attention.cu",
        "vface_tpu/ops/pallas_attention.py:302", _errs(out, want), ("abs", 2 * bf16_ulp(want.float().abs().max().item())),
        cuda_ms(lambda: FA.flash_attention_v2_stats(q, k, v, h)),
        cuda_ms(lambda: FA.flash_attention_v2_stats_ref(q, k, v, h), reps=3, warmup=1),
        cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf)),
        bound(4.0 * b * h * nq * nk * dh, (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * h * nq * 4), shape))


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
        _k7_bf16_row(rows, 1, nq, nk, c, 8, randn)

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
SCHED_STEPS = 8  # (b) and phase opts: cut from the reference's 50 + 50 steps for time (25 + 25 before the mesh phases, 15 + 15 before DIFT's)
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
MULTIFACE_STEPS = 8  # cut from 50 for time (20 before the mesh phases, 12 before DIFT's)


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
    gradients together). Then phase hires's fp32 part: one eval at
    ``HIRES_WINDOW``^2 (b = 2) and one loss + backward there (b = 1), where
    ds4's attention runs the tf32 kernel and K5's fp32 kernels at dh 160,
    each within ``HIRES_F32_TOL`` of the plain path, with its launches at dh
    160. Returns the launches of the two 512^2 runs."""
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

    def loss_grads(x=x9[:1], tgt=target):
        unet.zero_grad(set_to_none=True)
        loss = ((unet(x, ts[:1], ctx[:1]) - tgt) ** 2).mean()
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
    del eps_k, eps_p, grads_k, grads_p

    # phase hires (e): one eval without a gradient at HIRES_WINDOW^2 (96^2
    # latents), b = 2, and one loss + backward at b = 1: ds4's self-attention
    # at dh 160 on the tf32 kernel, its gradient on K5's fp32 kernels
    hh = HIRES_WINDOW // 8
    x9h = torch.randn((2, hh, hh, 9), generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        eps_h = unet(x9h, ts[:2], ctx[:2])
    torch.cuda.synchronize()
    hires_s, hires_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    hires_launches = kernel_counts()
    wide = _check_wide("fp32 eval", hires_launches, ("flash_attention_v1",))
    with torch.inference_mode(), plain_kernels():
        eps_hp = unet(x9h, ts[:2], ctx[:2])
    e_hires = rel(eps_h, eps_hp)
    log("hires_fp32_eval", image=f"{HIRES_WINDOW}^2", latent=f"{hh}^2", batch=2, eval_s=f"{hires_s:.3f}",
        peak_gib=f"{hires_peak:.2f}", eps_rel_l2_vs_plain=f"{e_hires:.3e}", tol=HIRES_F32_TOL,
        finite=bool(torch.isfinite(eps_h).all()), **{k: v for k, v in hires_launches.items() if v}, **wide)
    target_h = torch.randn((1, hh, hh, 4), generator=g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    loss_hk, grads_hk = loss_grads(x9h[:1], target_h)
    torch.cuda.synchronize()
    hires_train_s, hires_train_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    hires_train_launches = kernel_counts()
    wide_t = _check_wide("fp32 loss + backward", hires_train_launches,
                         ("flash_attention_stats_f32", "flash_attention_fp32_f32", "flash_attention_bwd_dq_f32",
                          "flash_attention_bwd_dkv_f32"))
    with plain_kernels():
        loss_hp, grads_hp = loss_grads(x9h[:1], target_h)
    unet.zero_grad(set_to_none=True)
    e_hires_grad = math.sqrt(sum(float((a - w).norm()) ** 2 for a, w in zip(grads_hk, grads_hp))) / math.sqrt(
        sum(float(w.norm()) ** 2 for w in grads_hp))
    finite_h = bool(torch.isfinite(eps_h).all()) and all(bool(torch.isfinite(a).all()) for a in grads_hk)
    log("hires_fp32_train", image=f"{HIRES_WINDOW}^2", latent=f"{hh}^2", batch=1, train_s=f"{hires_train_s:.3f}",
        peak_gib=f"{hires_train_peak:.2f}", loss_kernels=f"{loss_hk:.7f}", loss_plain=f"{loss_hp:.7f}",
        grad_rel_l2_vs_plain=f"{e_hires_grad:.3e}", tol=HIRES_F32_TOL, finite=finite_h,
        **{k: v for k, v in hires_train_launches.items() if v}, **wide_t)
    del unet, model, eps_h, eps_hp, grads_hk, grads_hp
    torch.cuda.empty_cache()
    if not (finite and e_eps <= tol and e_grad <= tol and finite_h and e_hires <= HIRES_F32_TOL
            and e_hires_grad <= HIRES_F32_TOL):
        raise SystemExit("chip_smoke: the fp32 UNet's kernel path disagrees with its plain path")
    for run, launched, wanted in (("eval", eval_launches, F32_EVAL_KERNELS),
                                  ("loss_backward", train_launches, F32_TRAIN_KERNELS),
                                  ("hires_eval", hires_launches, F32_EVAL_KERNELS),
                                  ("hires_loss_backward", hires_train_launches, F32_TRAIN_KERNELS)):
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


TRAIN_STEPS = 3  # timed steps after one warm-up step (cut from 5 for time)


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
CLI_STEPS = 8  # the CLI's 50 + 50 steps cut for the script's time (25 before the mesh phases, 15 before DIFT's)
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

    from vface_torch.io.video import read_y4m

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
        y4m_a = read_y4m(os.path.join(dir_a, "pair_a.y4m"))[0].astype(np.int16)

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
        torch.cuda.empty_cache()
        phase_mesh_cli(root, cfg["a"], base, frames_a, y4m_a)
        cli_flow_batches(seed)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    log("cli_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


TRAIN_CLI_STEPS, TRAIN_CLI_IMAGES = 3, 6  # steps (cut from 4 for time), synthetic pairs
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


def phase_train_cli(seed: int, resume: dict) -> dict:
    """The training CLI (``vface_torch.scripts.train.main``) in process at its
    full width (SD-v1 inpainting with its conditioner; batch 1 at 512^2) on a
    synthetic CelebA-HQ-layout directory: ``--resume`` from the ``last`` that
    phase mesh_train's two ranks saved (``resume``: its logdir and rank 0's
    parameter digest at exit), which the resumed model must hold bit for bit
    as loaded, then 3 steps (log_every 1, image_log_every 2, ckpt_every 3:
    one save; cut from 4 for time). The frozen set must still be the seeded init's. Removes the
    logdir. Returns the launches per step."""
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
        data, logdir = os.path.join(root, "celeba"), resume["logdir"]
        t0 = time.perf_counter()
        write_synthetic_celeba(data, TRAIN_CLI_IMAGES, size=cfg.image_size, seed=seed)
        data_s = time.perf_counter() - t0
        last_b, mon_b = _save_bytes(cfg)
        need = last_b + mon_b  # the new last's temporary file beside mesh_train's, and step_4
        free = shutil.disk_usage(logdir).free
        log("train_cli_disk", save_last_bytes=last_b, save_monitored_bytes=mon_b, need_bytes=need,
            free_bytes=free, where=logdir)
        if free < need:
            raise SystemExit(f"chip_smoke: train_cli needs {need} bytes of disk for its checkpoints, "
                             f"{logdir} has {free} free")
        os.environ.pop("VFACE_PLATFORM", None)  # the CLI's default device: the card
        name, steps = "train", TRAIN_CLI_STEPS
        argv = ["--dataset_dir", data, "--logdir", logdir, "--log_every", "1", "--image_log_every", "2",
                "--ckpt_every", str(steps), "--seed", str(seed), "--max_steps", str(steps), "--resume"]
        restored = {}

        class CheckedModel(VFaceModel):
            def load_params(self, state):
                # the resumed model as loaded, against mesh_train's rank 0 at its exit
                super().load_params(state)
                restored["equal"] = _param_digest(self) == resume["digest"]

        tee = _Tee()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee), mock.patch.object(train_driver, "VFaceModel", CheckedModel):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            raise SystemExit(f"chip_smoke: the training CLI's {name} run exited {rc}")
        torch.cuda.empty_cache()
        out = "".join(tee.parts)
        start = re.findall(r"\[train\] resumed from step (\d+)", out)
        log("train_cli_resume", restored_from_step=start[0] if start else "none",
            params_bit_equal_to_mesh_train_rank0_exit=restored.get("equal"),
            leaves=sum(len(sd) for sd in resume["digest"].values()))
        if not restored.get("equal") or start != [str(MESH_TRAIN_STEPS)]:
            raise SystemExit("chip_smoke: --resume did not restore mesh_train's last bit for bit")
        stages = json.loads(_STAGES.findall(out)[-1])
        with open(os.path.join(logdir, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh][-steps:]
        terms = {k: [r[k] for r in recs] for k in recs[0] if k.startswith("train/") and k != "train/sec_per_it"}
        clean = [r["train/sec_per_it"] * 1e3 for r in recs if r["step"] in _clean_steps(steps, 2)]
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
        # the frozen set (VAE, ArcFace, CLIP tower) as the seeded init made it
        init = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), conditioner=True)
        meta = VFaceModel(cfg, device="meta", conditioner=True)
        mask = trainable_mask(meta)
        del meta
        last = torch.load(os.path.join(ckdir, f"step_{steps:08d}"), map_location="cpu",
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
        shutil.rmtree(resume["root"], ignore_errors=True)
    log("train_cli_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")
    return dict(launches=launches, steps=steps)


def _param_digest(model) -> dict:
    """``{part: {name: sha256 of the tensor's bytes}}`` over ``model.param_state()``:
    bit equality of two models' parameters across processes."""
    import hashlib

    import torch

    return {part: {k: hashlib.sha256(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
                   for k, v in sd.items()} for part, sd in model.param_state().items()}


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


_RACECHECK_BUILDS: dict = {}  # phase_build starts racecheck's copies beside the kernels' builds


def _start_racecheck_builds() -> tuple:
    """Write :func:`phase_racecheck`'s two copies of ``geglu_ff.cu`` into a new
    temporary directory and start their ``nvcc`` builds, each logging to a
    file there; returns (directory, {copy: process}). At exit any build still
    running is stopped and the directory removed."""
    import atexit
    import shutil
    import tempfile

    from vface_torch.ops import _native

    src = (_native.CSRC / "geglu_ff.cu").read_text()
    if src.count(_AG_BARRIER) != 1 or src.count(_EPILOGUE) != 1:
        raise SystemExit("chip_smoke: racecheck cannot find the a*g barrier or the epilogue in geglu_ff.cu")
    delay = _EPILOGUE + "\n    if (warp == 3) __nanosleep(50000);"
    variants = {"delay": src.replace(_EPILOGUE, delay),
                "no_barrier": src.replace(_EPILOGUE, delay).replace(_AG_BARRIER, "// a*g barrier removed")}
    root = tempfile.mkdtemp(prefix="vface_racecheck_")
    shutil.copy(_native.CSRC / "hopper.cuh", root)
    procs = {}
    for name, text in variants.items():
        path = os.path.join(root, f"geglu_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", os.path.join(root, f"lib{name}.so"), path]
        with open(os.path.join(root, f"{name}.log"), "w") as out:
            procs[name] = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)

    atexit.register(stop)
    return root, procs


def phase_racecheck() -> None:
    """K2's fused kernel's a*g barrier (the named barrier between a
    warpgroup's epilogue writes of a*g and its second product's reads).
    Builds copies of ``geglu_ff.cu`` (started in phase build, beside the
    kernels' builds): one with the barrier removed and the
    epilogue of each warpgroup's last warp delayed 50 us, one with the delay
    alone. A launch of each at C = 320 (M = 4096, 128-row tiles) against the
    shipped kernel, the three in processes of their own at once: the delay
    alone must leave the output bit for bit, and
    the phase reports whether the copy without the barrier differs (the check
    fails that copy) or not. Then ``compute-sanitizer --tool racecheck`` on one
    launch of the shipped kernel and of the copy, where the toolkit ships it
    and it runs."""
    import shutil

    import torch

    from vface_torch.ops import _native

    root, procs = _RACECHECK_BUILDS.pop("builds", None) or _start_racecheck_builds()
    try:
        for name, proc in procs.items():
            if proc.wait():
                text = open(os.path.join(root, f"{name}.log"), errors="replace").read()
                raise SystemExit(f"chip_smoke: racecheck's {name} copy did not build:\n{text[-2000:]}")
        libs = {"shipped": str(_native.lib_path("geglu_ff")),
                **{n: os.path.join(root, f"lib{n}.so") for n in procs}}
        script = os.path.join(root, "one_launch.py")
        with open(script, "w") as fh:
            fh.write(_ONE_LAUNCH)
        runs = {name: subprocess.Popen([sys.executable, script, lib, "4096", os.path.join(root, f"{name}.pt")],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for name, lib in libs.items()}
        outs = {}
        for name, run in runs.items():
            try:
                err = run.communicate(timeout=120)[1]
            except subprocess.TimeoutExpired:
                for other in runs.values():
                    other.kill()
                    other.wait()
                raise SystemExit(f"chip_smoke: racecheck's launch of {name} took over 120 s")
            if run.returncode:
                raise SystemExit(f"chip_smoke: racecheck's launch of {name} failed:\n{err[-2000:]}")
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
                if "Device not supported" in text:  # it runs on no copy here: skip the second start
                    break
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
        src_emb = guided.id_embedding(model.conditioner.arcface, x["src01"][:1] * (1 - x["keep"][:1]))
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
    params npz (``save_params_npz``'s layout; no prefix when it is empty):
    Dense and Conv ``weight`` -> ``kernel`` (transposed to (in, out) / HWIO /
    DHWIO), a norm's 1-D ``weight`` -> ``scale``, the rest as they are."""
    out = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        a = value.detach().float().cpu().numpy()
        if leaf == "weight" and a.ndim in (2, 4, 5):
            leaf, a = "kernel", (a.T if a.ndim == 2 else a.transpose(*range(2, a.ndim), 1, 0))
        elif leaf == "weight":
            leaf = "scale"
        out["/".join(p for p in [prefix, *mods, leaf] if p)] = a
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


# ------------------------------------------------------------ multi-GPU phases
MESH_RANKS = 2
MESH_FS_FRAMES, MESH_FS_WINDOW = 7, 6  # mesh_gate: one frame-sharded window (3 frames a rank) and a 1-frame one
MESH_WP_FRAMES, MESH_WP_WINDOW = 8, 3  # mesh_gate: 2 full windows dealt to the ranks and a 2-frame one
MESH_TRAIN_STEPS, MESH_TRAIN_LR = 2, 1e-5  # mesh_train: warm-up 1, so that the second step moves the params
MESH_UPDATE_TOL = 0.2  # mesh_train: relative L2 of last's update and moments against one rank's (a lost one reads 1)


def _mesh_child(rank: int, world: int, tmp: str, fn_name: str) -> None:
    """One rank of a multi-process phase: NCCL on a card of its own where the
    host has ``world`` cards, else gloo, every rank on card 0; runs
    ``fn_name(mesh, args)`` and saves its result for the parent."""
    import traceback

    import torch

    from vface_torch.parallel.mesh import destroy, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        own = torch.cuda.device_count() >= world
        mesh = make_mesh(backend="nccl" if own else "gloo", device=f"cuda:{rank if own else 0}",
                         init_method=f"file://{tmp}/pg", rank=rank, world_size=world)
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        out = globals()[fn_name](mesh, args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy()


def run_ranks(fn_name: str, args, timeout: float, world: int = MESH_RANKS) -> list:
    """``fn_name(mesh, args)`` on ``world`` processes (spawned; a file rendezvous
    in a temporary directory); every process is joined or killed; a rank's
    failure fails the script with its traceback."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="vface_mesh_")
    try:
        torch.save(args, os.path.join(tmp, "args.pt"))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_child, args=(r, world, tmp, fn_name)) for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.perf_counter() + timeout
        for proc in procs:
            proc.join(max(1.0, deadline - time.perf_counter()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.startswith("err")]
        if errs or any(proc.exitcode != 0 for proc in procs):
            raise SystemExit(f"chip_smoke: {fn_name} failed on its ranks (exit codes "
                             f"{[proc.exitcode for proc in procs]}):\n" + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_gate_rank(mesh, a) -> dict:
    """mesh_gate on one rank: the frame-sharded and window-parallel swaps, the
    no-halo control, and on rank 0 the sequential loops they are held to."""
    from unittest import mock

    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.parallel import mesh as M
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline
    from vface_torch.utils.convert import init_aux_params, init_params

    seed, dev = a["seed"], mesh.device
    cfg = ModelConfig.sd_v1_inpaint(dtype=torch.float32)
    model = VFaceModel(cfg, device=dev, conditioner=True)
    model.load_params(init_params(cfg, torch.Generator(device=dev).manual_seed(seed), conditioner=True))
    aux = init_aux_params(torch.Generator(device=dev).manual_seed(seed + 1))
    base = SwapOptions(ddim_steps=GATE_STEPS, inversion_steps=GATE_STEPS, image_size=cfg.image_size,
                       parser_size=512, raft_iters=20)
    pipe = lambda w: VideoSwapPipeline(model, dataclasses.replace(base, window=w), device=dev, aux_params=aux)
    fs_clip = synthetic_clip(MESH_FS_FRAMES, GATE_HW, seed + 40, device=dev)
    wp_clip = synthetic_clip(MESH_WP_FRAMES, GATE_HW, seed + 42, device=dev)
    source = synthetic_clip(1, GATE_HW, seed + 41, device=dev)[0]
    out = dict(backend=mesh.backend, world=mesh.size, device=str(dev))

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        out[name + "_s"] = time.perf_counter() - t0
        out[name + "_launches"] = {k: v for k, v in kernel_counts().items() if v}
        return res

    torch.cuda.reset_peak_memory_stats(dev)
    fs = timed("frame_sharded", lambda: pipe(MESH_FS_WINDOW).swap_video_frames_frame_sharded(fs_clip, source, mesh))
    wp = timed("window_parallel", lambda: pipe(MESH_WP_WINDOW).swap_video_frames_sharded(wp_clip, source, mesh))
    # the control: each rank's halo replaced by its own first frame
    with mock.patch.object(M, "frame_halo_exchange", lambda x, axis_name="data": x[0]):
        ctl = timed("no_halo", lambda: pipe(MESH_FS_WINDOW).swap_video_frames_frame_sharded(fs_clip, source, mesh))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if mesh.rank == 0:
        seq_fs = timed("sequential_fs", lambda: pipe(MESH_FS_WINDOW).swap_video_frames(fs_clip, source))
        seq_wp = timed("sequential_wp", lambda: pipe(MESH_WP_WINDOW).swap_video_frames(wp_clip, source))
        out.update(frame_sharded_max_abs=float((fs - seq_fs).abs().max()),
                   window_parallel_max_abs=float((wp - seq_wp).abs().max()),
                   no_halo_max_abs=float((ctl - seq_fs).abs().max()),
                   shapes_ok=tuple(fs.shape) == (MESH_FS_FRAMES, *GATE_HW, 3)
                   and tuple(wp.shape) == (MESH_WP_FRAMES, *GATE_HW, 3),
                   finite=bool(torch.isfinite(fs).all() and torch.isfinite(wp).all()))
    else:
        out.update(returns_none=fs is None and wp is None and ctl is None)
    return out


def phase_mesh_gate(seed: int) -> None:
    """Phase mesh_gate: the multi-GPU video paths on the card, two ranks
    (NCCL across two cards where the host has them, else gloo with both
    ranks on card 0) at the exactness gate's operating point (phase sched
    (a): the SD-v1 inpainting model at fp32 with its conditioner, seeded,
    512^2 crops, 4 + 4 steps, RAFT 20, parser 512). The frame-sharded swap
    of a 7-frame clip at window 6 (3 frames a rank, the FGATS halo between
    them, and a 1-frame window on rank 0) and the window-parallel swap of an
    8-frame clip at window 3 (two full windows dealt to the ranks and a
    2-frame one) each within ``GATE_TOL`` of the sequential loop on rank 0;
    the frame-sharded swap with each rank's halo replaced by its own first
    frame must miss that limit. Per rank: seconds, launches, peak memory;
    the backend and the world size."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    outs = run_ranks("_mesh_gate_rank", {"seed": seed}, timeout=600)
    r0 = outs[0]
    for r, o in enumerate(outs):
        log("mesh_gate_rank", rank=r, backend=o["backend"], world=o["world"], device=o["device"],
            peak_gib=f"{o['peak_gib']:.2f}", **{k: f"{v:.3f}" for k, v in o.items() if k.endswith("_s")},
            frame_sharded_launches=",".join(f"{k}:{v}" for k, v in o["frame_sharded_launches"].items()))
    log("mesh_gate", config="sd_v1_inpaint fp32 + conditioner", backend=r0["backend"], world=r0["world"],
        tol=GATE_TOL, frame_sharded_frames=MESH_FS_FRAMES, frame_sharded_window=MESH_FS_WINDOW,
        window_parallel_frames=MESH_WP_FRAMES, window_parallel_window=MESH_WP_WINDOW, ddim_steps=GATE_STEPS,
        frame_sharded_max_abs=f"{r0['frame_sharded_max_abs']:.3e}",
        window_parallel_max_abs=f"{r0['window_parallel_max_abs']:.3e}",
        no_halo_max_abs=f"{r0['no_halo_max_abs']:.3e}", no_halo_over_tol=f"{r0['no_halo_max_abs'] / GATE_TOL:.1f}",
        finite=r0["finite"], shapes_ok=r0["shapes_ok"], other_ranks_return_none=outs[1]["returns_none"],
        wall_s=f"{time.perf_counter() - t_phase:.3f}")
    missing = [k for k in (*F32_EVAL_KERNELS, "gn_sums") for o in outs if not o["frame_sharded_launches"].get(k)]
    if missing:
        raise SystemExit(f"chip_smoke: the frame-sharded swap launched no {sorted(set(missing))} on a rank")
    if not (r0["finite"] and r0["shapes_ok"] and outs[1]["returns_none"]):
        raise SystemExit("chip_smoke: the mesh swaps' frames are malformed or the other rank returned frames")
    for key in ("frame_sharded_max_abs", "window_parallel_max_abs"):
        if not r0[key] <= GATE_TOL:
            raise SystemExit(f"chip_smoke: {key} {r0[key]:.3e} is over the gate {GATE_TOL}")
    if not r0["no_halo_max_abs"] > GATE_TOL:
        raise SystemExit(f"chip_smoke: without the halo the frame-sharded swap is within {r0['no_halo_max_abs']:.3e} "
                         "of the loop: the gate cannot tell a missing halo")


def _mesh_train_rank(mesh, a) -> dict:
    """mesh_train on one rank: ``train(n_data=2)``; rank 0 saves its first
    step's averaged UNet gradients for the parent."""
    import torch

    from vface_torch.models.ldm import ModelConfig
    from vface_torch.parallel.mesh import local_state_bytes
    from vface_torch.pipelines import train_driver as TD
    from vface_torch.pipelines.train import TrainConfig

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = mesh.device
    opts, saved = [], []
    real_opt, real_step = TD.make_optimizer, TD.make_train_step
    TD.make_optimizer = lambda *x, **k: opts.append(real_opt(*x, **k)) or opts[-1]

    def step_maker(model, *x, **k):
        step = real_step(model, *x, **k)

        def first_grads(batch, gen):
            logs = step(batch, gen)
            if not saved:
                saved.append(1)
                if mesh.rank == 0:
                    torch.save(_unet_grads(model).cpu(), a["grads_path"])
            return logs

        return first_grads

    TD.make_train_step = step_maker
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    model = TD.train(ModelConfig.sd_v1_inpaint(), TrainConfig(learning_rate=MESH_TRAIN_LR, warmup_steps=1),
                     TD.DriverConfig(logdir=a["logdir"], max_steps=MESH_TRAIN_STEPS, log_every=1,
                                     image_log_every=10**6, ckpt_every=10**6, batch_size=1, seed=a["seed"]),
                     iter([a["batch"]] * (MESH_TRAIN_STEPS + 1)), device=str(dev), n_data=mesh.size)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                opt_bytes=local_state_bytes(opts[0][0]), backend=mesh.backend, world=mesh.size,
                launches={k: v for k, v in kernel_counts().items() if v}, digest=_param_digest(model))


def _halves_grads(model, batch: dict, tcfg, seed: int):
    """The UNet gradients two ranks average, computed on this process: each
    row of the global batch of 2 at batch 1, as rank r computes it (the
    generator from the seed, the global batch's draws and its rows, the
    reference batch gathered for the flip), each loss halved and summed."""
    from unittest import mock

    import torch

    from vface_torch.parallel.mesh import Mesh
    from vface_torch.pipelines import train as T

    whole = {batch[k].shape[1]: batch[k] for k in ("ref_clip", "ref_face01")}
    model.zero_grad(set_to_none=True)
    with mock.patch.object(T, "all_gather_rows", lambda x, mesh: whole[x.shape[1]]):
        for r in range(MESH_RANKS):
            fake = Mesh(rank=r, size=MESH_RANKS, device=torch.device("cuda"))
            gen = torch.Generator(device="cuda").manual_seed(seed)
            loss, _ = T.p_losses_face(model, {k: v[r:r + 1] for k, v in batch.items()}, gen, tcfg, mesh=fake)
            (loss / MESH_RANKS).backward()
    return _unet_grads(model)


def _unet_grads(model):
    import torch

    return torch.cat([p.grad.reshape(-1).float() for p in model.unet.parameters() if p.grad is not None])


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def phase_mesh_train(seed: int) -> dict:
    """Phase mesh_train: ``train(n_data=2)`` at full width (SD-v1 inpainting
    with its conditioner, bf16, seeded) over two ranks on the card (as
    mesh_gate), batch 1 a rank (a global batch of 2 seeded 512^2 samples),
    2 steps (lr 1e-5, warm-up 1), the AdamW moments sharded (ZeRO-1), cuDNN
    deterministic. Held: the ranks' parameters bit-equal at exit; on one
    process, the ranks' first step as they compute it (each row at batch 1
    from the same generator state, the losses halved and summed), which the
    ranks' averaged UNet gradients must meet within 1e-5 relative L2; the
    same 2 steps on the global batch at batch 2, whose UNet params the
    ranks' saved ``last`` meets within 1e-3 relative L2 and whose update
    (params minus init) within 0.2 (at lr 1e-5 the update is ~4e-4 of the
    params' norm, so the 1e-3 limit alone cannot see a lost step; a lost
    update reads 1); ``last``'s gathered moments read into a one-rank AdamW
    and within 0.2 relative L2 of that run's; each rank's optimizer-state
    bytes about half the one-rank total (0.3-0.7). The first step's
    gradients against the global batch's are printed beside what the batch
    shape alone moves them (bf16 kernels round by batch). Per rank: step
    seconds, peak memory. Returns ``last``'s logdir (and the temporary root
    holding it) with rank 0's parameter digest at exit, for the training
    CLI's ``--resume`` (phase train_cli)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.pipelines.train import TrainConfig, make_optimizer, make_train_step
    from vface_torch.utils.convert import init_params

    t_phase = time.perf_counter()
    cfg = ModelConfig.sd_v1_inpaint()
    root = tempfile.mkdtemp(prefix="vface_mesh_train_")
    try:
        last_b, _ = _save_bytes(cfg)
        n_unet = sum(p.numel() for p in VFaceModel(cfg, device="meta").unet.parameters())
        need, free = 2 * last_b + 4 * n_unet, shutil.disk_usage(root).free
        log("mesh_train_disk", save_last_bytes=last_b, grads_bytes=4 * n_unet, need_bytes=need, free_bytes=free)
        if free < need:
            raise SystemExit(f"chip_smoke: mesh_train needs {need} bytes of disk, {root} has {free} free")
        r = np.random.default_rng(seed + 50)
        s, clip = cfg.image_size, cfg.cond.clip.image_size
        b = MESH_RANKS
        batch = {"gt_image": r.uniform(-1, 1, (b, s, s, 3)), "inpaint": r.uniform(-1, 1, (b, s, s, 3)),
                 "mask": (r.uniform(size=(b, s, s, 1)) > 0.3), "ref_clip": r.normal(size=(b, clip, clip, 3)) * 0.3,
                 "ref_face01": r.uniform(size=(b, 112, 112, 3)), "landmarks": r.uniform(size=(b, 136))}
        batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
        logdir, grads_path = os.path.join(root, "logs"), os.path.join(root, "grads.pt")
        torch.cuda.empty_cache()
        outs = run_ranks("_mesh_train_rank", dict(seed=seed, batch=batch, logdir=logdir, grads_path=grads_path),
                         timeout=600)
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            step_s = [rec["train/sec_per_it"] for rec in map(json.loads, f)]
        ranks_equal = all(o["digest"] == outs[0]["digest"] for o in outs)

        # one rank, the global batch, the same seed
        deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.cuda.reset_peak_memory_stats()
        model = VFaceModel(cfg, device="cuda", conditioner=True)
        model.load_params(init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), conditioner=True))
        init = torch.cat([p.detach().reshape(-1).float() for p in model.unet.parameters()])
        tcfg = TrainConfig(learning_rate=MESH_TRAIN_LR, warmup_steps=1)
        opt, sched = make_optimizer(tcfg, model)
        step = make_train_step(model, opt, sched, tcfg)
        dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        mesh_g = torch.load(grads_path).cuda()
        os.remove(grads_path)
        # the ranks' first step on one process: each half at batch 1 with the global batch's draws and flip
        halves_g = _halves_grads(model, dev_batch, tcfg, seed)
        opt.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        step(dev_batch, gen)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_g = _unet_grads(model)
        halves_err, grads_err, shape_err = _rel_l2(mesh_g, halves_g), _rel_l2(mesh_g, one_g), _rel_l2(halves_g, one_g)
        del mesh_g, halves_g, one_g
        for _ in range(MESH_TRAIN_STEPS - 1):
            step(dev_batch, gen)
        one_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        total = sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor) and v.ndim > 0)
        one = torch.cat([p.detach().reshape(-1).float() for p in model.unet.parameters()])
        # last as saved (mapped, not read whole): its UNet params and its gathered moments
        last = torch.load(os.path.join(logdir, "checkpoints", "last"), map_location="cpu", mmap=True,
                          weights_only=True)
        mesh_p = torch.cat([last["state"]["params"]["unet"][k].reshape(-1).float().cuda()
                            for k, _ in model.unet.named_parameters()])
        params_err, update_err = _rel_l2(mesh_p, one), float((mesh_p - one).norm() / (one - init).norm())
        fresh, _ = make_optimizer(tcfg, model)
        fresh.load_state_dict(last["state"]["opt_state"])  # the gathered state, the one-device layout
        sq = lambda st, key: sum(float((st[p][key].float() ** 2).sum()) for p in st)
        diff = lambda key: sum(float(((fresh.state[p][key] - opt.state[p][key]).float() ** 2).sum()) for p in opt.state)
        moments_err = max(math.sqrt(diff(k) / sq(opt.state, k)) for k in ("exp_avg", "exp_avg_sq"))
        last_step, n_state = last["step"], len(fresh.state)
        resumed_ok = last_step == MESH_TRAIN_STEPS and n_state == len(opt.state)
        del model, opt, fresh, last, init, one, mesh_p
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    shares = [o["opt_bytes"] / total for o in outs]
    for r, o in enumerate(outs):
        log("mesh_train_rank", rank=r, backend=o["backend"], world=o["world"], wall_s=f"{o['wall_s']:.3f}",
            peak_gib=f"{o['peak_gib']:.2f}", opt_state_bytes=o["opt_bytes"], opt_state_share=f"{shares[r]:.4f}",
            **o["launches"])
    log("mesh_train", config="sd_v1_inpaint bf16 + conditioner", ranks=MESH_RANKS, batch_per_rank=1,
        steps=MESH_TRAIN_STEPS, lr=MESH_TRAIN_LR, step_s=",".join(f"{x:.3f}" for x in step_s),
        one_rank_step_s=f"{one_s:.3f}", one_rank_peak_gib=f"{one_peak:.2f}", one_rank_opt_state_bytes=total,
        ranks_params_bit_equal=ranks_equal, unet_grads_vs_halves_rel_l2=f"{halves_err:.3e}",
        unet_grads_vs_global_batch_rel_l2=f"{grads_err:.3e}", halves_vs_global_batch_rel_l2=f"{shape_err:.3e}",
        params_rel_l2=f"{params_err:.3e}", update_rel_l2=f"{update_err:.3e}", moments_rel_l2=f"{moments_err:.3e}",
        halves_tol=1e-5, params_tol=1e-3, update_tol=MESH_UPDATE_TOL, moments_tol=MESH_UPDATE_TOL,
        last_step=last_step, last_moment_entries=n_state, wall_s=f"{time.perf_counter() - t_phase:.3f}")
    fails = []
    if not ranks_equal:
        fails.append("the ranks' parameters differ at exit")
    if not halves_err <= 1e-5:
        fails.append(f"two ranks' gradients are {halves_err:.3e} from the same halves on one rank (limit 1e-5)")
    if not (params_err <= 1e-3 and update_err <= MESH_UPDATE_TOL):
        fails.append(f"last's params are {params_err:.3e} from the one-rank run's (limit 1e-3), its update "
                     f"{update_err:.3e} from that run's (limit {MESH_UPDATE_TOL})")
    if not (moments_err <= MESH_UPDATE_TOL and resumed_ok):
        fails.append(f"last's gathered moments are {moments_err:.3e} from the one-rank run's (limit "
                     f"{MESH_UPDATE_TOL}), or its step {last_step} / {n_state} entries are not the one-rank run's")
    missing = sorted({k for o in outs for k in TRAIN_KERNELS if not o["launches"].get(k)})
    if missing:
        fails.append(f"a rank launched no {missing}")
    if not all(0.3 <= x <= 0.7 for x in shares):
        fails.append(f"the ZeRO-1 shares are {shares}")
    if fails:
        shutil.rmtree(root, ignore_errors=True)
        raise SystemExit("chip_smoke: mesh_train: " + "; ".join(fails))
    return dict(root=root, logdir=logdir, digest=outs[0]["digest"])


MESH_CLI_WRAPPER = """import runpy, sys
import torch
# the script's precision flags (set in main), so that the frames compare with run A's
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
try:
    runpy.run_module("vface_torch.scripts.vface_video_swap", run_name="__main__", alter_sys=True)
finally:
    from vface_torch.ops import flash_attention as FA, geglu_ff as FF, gn_sums as GN

    print("[mesh_cli] peak_gib=%.3f flash_attention=%d geglu_ff=%d geglu_ff_wide=%d gn_sums=%d" % (
        torch.cuda.max_memory_allocated() / 2**30, FA.LAUNCHES["flash_attention"], FF.LAUNCHES,
        FF.WIDE_LAUNCHES, GN.LAUNCHES), flush=True)
"""


def phase_mesh_cli(root: str, config_a: str, base: list, frames_a, y4m_a) -> None:
    """Phase mesh_cli (inside phase cli, on its inputs): the video CLI under
    ``torchrun --standalone --nproc_per_node 1`` (NCCL, world size 1) with
    ``--mesh_data 1`` and with ``--mesh_frames 1`` on pair A at the cli
    phase's steps, the two torchruns at once (each holds ~24 GiB of the card;
    their frames/s share it); the module runs through ``runpy`` in a wrapper
    that sets the script's precision flags and prints the process's peak
    memory at its exit. The ``--mesh_data`` sink's PNGs within 1 uint8 level
    of run A's and the ``--mesh_frames`` Y4M within 2 of run A's (its path
    keeps no sink, as the JAX package's); frames/s and peak memory."""
    import numpy as np

    from vface_torch.io.video import read_y4m

    wrapper = os.path.join(root, "mesh_cli_main.py")
    with open(wrapper, "w") as f:
        f.write(MESH_CLI_WRAPPER)
    env = dict(os.environ, PYTHONPATH=os.getcwd() + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("VFACE_PLATFORM", None)
    runs = {}
    for flag in ("--mesh_data", "--mesh_frames"):
        outdir = os.path.join(root, "mesh" + flag.split("_")[1])
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", wrapper,
               "--config", config_a, "--outdir", outdir, *base, flag, "1"]
        logs = tuple(open(f"{outdir}.{kind}.txt", "w+") for kind in ("out", "err"))
        runs[flag] = (outdir, logs, subprocess.Popen(cmd, env=env, stdout=logs[0], stderr=logs[1], text=True))
    t0 = time.perf_counter()
    walls = {}
    try:
        while len(walls) < len(runs):
            for flag, (_, _, proc) in runs.items():
                if flag not in walls and proc.poll() is not None:
                    walls[flag] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                raise SystemExit(f"chip_smoke: the torchruns {sorted(set(runs) - set(walls))} took over 600 s")
            time.sleep(0.2)
    finally:
        for _, _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for flag, (outdir, logs, proc) in runs.items():
        for f in logs:
            f.seek(0)
        stdout, stderr = (f.read() for f in logs)
        for f in logs:
            f.close()
        done = _DONE.search(stdout)
        peak = re.search(r"\[mesh_cli\] peak_gib=([\d.]+) (.*)", stdout)
        launches = dict(kv.split("=") for kv in peak[2].split()) if peak else {}
        if proc.returncode != 0 or done is None or "[fail]" in stdout:
            raise SystemExit(f"chip_smoke: torchrun {flag} 1 failed (rc {proc.returncode}):\n"
                             + stdout[-3000:] + stderr[-3000:])
        y4m = read_y4m(os.path.join(outdir, "pair_a.y4m"))[0].astype(np.int16)
        y4m_diff = int(np.abs(y4m - y4m_a).max())
        png_diff = None
        if flag == "--mesh_data":
            png_diff = int(np.abs(_read_frames(os.path.join(outdir, "pair_a_frames"), CLI_FRAMES) - frames_a).max())
        log("mesh_cli", flag=flag, world=1, backend="nccl", at_once=len(runs), frames=int(done[2]), swap_s=done[3],
            frames_per_s=done[4], peak_gib=peak[1] if peak else "not read", wall_s=f"{walls[flag]:.3f}",
            y4m_max_level_diff=y4m_diff, png_max_level_diff=png_diff, **launches)
        missing = [k for k in SWAP_KERNELS if int(launches.get(k, 0)) == 0]
        if missing:
            raise SystemExit(f"chip_smoke: torchrun {flag} 1 launched no {missing}")
        if y4m_diff > 2 or (png_diff is not None and png_diff > 1):
            raise SystemExit(f"chip_smoke: torchrun {flag} 1's frames are {y4m_diff} / {png_diff} levels from run A's")


EVAL_PAIRS = 16  # evaluate_all: 16 render_face images in each directory
EVAL_CHECK = 4  # images whose features are held card against CPU


def _seeded_eval(module, generator, gain: float = 1.0):
    """An eval net's seeded weights in place: conv / dense kernels N(0,
    gain / fan_in) (gain 2, He-normal, keeps a deep plain ReLU chain such as
    InceptionV3 at activations of order 1; the residual nets take 1, since
    each residual add grows them: IR-SE-50 at gain 2 grows them ~10^4-fold
    and amplifies fp32 round-off until a +-1e-7 input change moves its
    embedding by 2.4e-2 of the peak on the CPU alone,
    ``tests/test_torch_irse50_scale.py``, so the card gate holds it at gain
    1), biases N(0, 0.02^2), frozen-BN scales 1 + N(0, 0.05^2), biases and
    means N(0, 0.05^2), variances U(0.5, 1.5); returns the module."""
    import torch

    from vface_torch.models.arcface import _FrozenBNParams
    from vface_torch.models.layers import Conv, Dense

    with torch.no_grad():
        for mod in module.modules():
            rn = lambda t: torch.randn(t.shape, generator=generator, device=t.device)
            if isinstance(mod, (Conv, Dense)):
                mod.weight.copy_(rn(mod.weight) * math.sqrt(gain / math.prod(mod.weight.shape[1:])))
                if mod.bias is not None:
                    mod.bias.copy_(rn(mod.bias) * 0.02)
            elif isinstance(mod, _FrozenBNParams):
                mod.weight.copy_(1.0 + 0.05 * rn(mod.weight))
                mod.bias.copy_(0.05 * rn(mod.bias))
                mod.mean.copy_(0.05 * rn(mod.mean))
                mod.var.copy_(0.5 + torch.rand(mod.var.shape, generator=generator, device=mod.var.device))
    return module.eval()


def phase_eval(seed: int, base: dict) -> None:
    """Phase eval: ``evaluate_all`` at full size on the card with seeded eval
    nets (InceptionV3's pool3 with He kernels, IR-SE-50, Hopenet and the 3DMM
    regressor with LeCun ones; perturbed frozen-BN statistics) over 16 ``render_face``
    512^2 images in each of the results, dataset, source and target
    directories (``_load_dir`` at 256^2; Inception at 299^2, the ResNet-50
    nets at 224^2): seconds per metric and peak memory. The features of 4
    images from each net, card against CPU, within 1e-4 of each output's
    peak, with TF32 switched on around the card's call (the eval entry
    points turn it off for their own work); IR-SE-50 at He scale (gain 2),
    card against CPU and the CPU's own motion under a +-1e-7 input change,
    reported (see :func:`_seeded_eval`). ``evaluate_temporal`` on the
    sched phase's sequential 12-frame 720p swap at 360x640 with RAFT's flow
    (20 iterations) between its frames."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vface_torch.eval.expression import FaceReconNet, face_coeffs
    from vface_torch.eval.fid import InceptionV3Pool3, inception_features
    from vface_torch.eval.harness import evaluate_all
    from vface_torch.eval.pose import Hopenet, head_pose
    from vface_torch.eval.temporal import evaluate_temporal
    from vface_torch.io.image import write_png
    from vface_torch.models.arcface import IRSE50
    from vface_torch.models.raft import RAFT, RAFTConfig
    from vface_torch.ops.warp import resize_bilinear
    from vface_torch.preprocess.synthetic_faces import render_face

    # the package exports the function id_retrieval under the module's name, as the JAX package does
    embed_faces = importlib.import_module("vface_torch.eval.id_retrieval").embed_faces
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed + 60)
    nets = {}
    for name, cls in (("inception", InceptionV3Pool3), ("arcface", IRSE50), ("hopenet", Hopenet),
                      ("facerecon", FaceReconNet)):
        with torch.device("cuda"):
            nets[name] = _seeded_eval(cls(), g, gain=2.0 if name == "inception" else 1.0)
    root = tempfile.mkdtemp(prefix="vface_eval_")
    try:
        dirs = {}
        for i, key in enumerate(("results", "dataset", "sources", "targets")):
            dirs[key] = os.path.join(root, key)
            os.makedirs(dirs[key])
            rng = np.random.default_rng(seed + 70 + i)
            for j in range(EVAL_PAIRS):
                img = render_face(rng, 512)[0]
                write_png(os.path.join(dirs[key], f"{j:03d}.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        report = evaluate_all(dirs["results"], dirs["dataset"], dirs["sources"], dirs["targets"], nets,
                              out_path=os.path.join(root, "report.jsonl"), device="cuda", timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        # card against CPU on 4 images per net, TF32 on around the card's calls
        from vface_torch.eval.harness import _load_dir

        imgs = _load_dir(dirs["results"], limit=EVAL_CHECK)
        cpu = {k: _seeded_copy(v) for k, v in nets.items()}
        fns = {"inception": inception_features, "arcface": embed_faces, "hopenet": head_pose,
               "facerecon": face_coeffs}
        errs = {}
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        for name, fn in fns.items():
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                got = fn(nets[name], imgs)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            want = fn(cpu[name], imgs)
            errs[name] = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        he_scale_report(seed, imgs, errs["arcface"])
        # the temporal metrics of the sched phase's sequential swap
        frames = torch.from_numpy(base["u8"]).cuda().float() / 255.0
        small = resize_bilinear(frames, 360, 640)
        with torch.device("cuda"):
            raft = RAFT(RAFTConfig(iters=20)).eval()
        raft.load_state_dict(base["aux"]["raft"])
        t1 = time.perf_counter()
        with torch.inference_mode():
            x = small * 2 - 1
            flow = torch.cat([raft(x[i + 1:i + 6], x[i:min(i + 5, x.shape[0] - 1)])
                              for i in range(0, x.shape[0] - 1, 5)])
        temporal = evaluate_temporal(nets["arcface"], small, flow.cpu().numpy(), device="cuda")
        torch.cuda.synchronize()
        temporal_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("eval", images=EVAL_PAIRS, **{k: f"{v:.6g}" for k, v in report.items()},
        **{f"{k}_s": f"{v:.3f}" for k, v in timings.items()}, wall_s=f"{wall:.3f}", peak_gib=f"{peak:.2f}")
    log("eval_card_vs_cpu", images=EVAL_CHECK, tol=1e-4, tf32_on_around_the_call=True,
        **{f"{k}_max_rel": f"{v:.3e}" for k, v in errs.items()})
    log("eval_temporal", frames=int(small.shape[0]), hw="360x640", raft_iters=20, seconds=f"{temporal_s:.3f}",
        **{k: f"{v:.6g}" for k, v in temporal.items()}, phase_s=f"{time.perf_counter() - t_phase:.3f}")
    want_keys = {"fid", "id_top1", "id_top5", "id_mean_cosine", "pose_l2", "expression_l2"}
    finite = all(math.isfinite(v) for v in (*report.values(), *temporal.values()))
    if set(report) != want_keys or not finite or set(temporal) != {"tl_id", "tg_id", "warp_error"}:
        raise SystemExit(f"chip_smoke: evaluate_all / evaluate_temporal gave {report} / {temporal}")
    bad = [k for k, v in errs.items() if not v <= 1e-4]
    if bad:
        raise SystemExit(f"chip_smoke: the eval features of {bad} on the card are over 1e-4 from the CPU's: {errs}")


def he_scale_report(seed: int, imgs, lecun_err: float) -> None:
    """IR-SE-50 at He scale (gain 2), reported and not gated: the card's
    embeddings of ``imgs`` against the CPU's, beside the CPU's own motion
    under a +-1e-7 change of the input (:func:`_seeded_eval`)."""
    import numpy as np
    import torch

    from vface_torch.models.arcface import IRSE50

    embed_faces = importlib.import_module("vface_torch.eval.id_retrieval").embed_faces
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    with torch.device("cuda"):
        he = _seeded_eval(IRSE50(), torch.Generator(device="cuda").manual_seed(seed + 61), gain=2.0)
    he_cpu = _seeded_copy(he)
    want = embed_faces(he_cpu, imgs, device="cpu")
    sign = np.random.default_rng(seed + 62).choice([-1.0, 1.0], size=imgs.shape).astype(np.float32)
    log("eval_he_scale", net="IR-SE-50 at gain 2", images=len(imgs),
        card_vs_cpu_max_rel=f"{rel(embed_faces(he, imgs, device='cuda'), want):.3e}",
        cpu_motion_1e7_max_rel=f"{rel(embed_faces(he_cpu, imgs + 1e-7 * sign, device='cpu'), want):.3e}",
        lecun_card_vs_cpu_max_rel=f"{lecun_err:.3e}")


def _seeded_copy(net):
    """A CPU copy of a seeded eval net."""
    import copy

    return copy.deepcopy(net).cpu().eval()


DIFT_SIZE = 512  # make_prior on 512^2 crops: one b = 2 UNet forward at SD-v1 widths
DIFT_TOL = 3e-2  # relative L2 of the features, kernel path against the plain one at bf16
AUX_GATE_TOL = 1e-4  # the tiny fp32 DIFT and VQ, CLIP text, a face-vid2vid frame: card vs CPU, of the peak
AUX_FRAMES = 8  # driven_demo's driving Y4M
CROP_FACES, CROP_FRAME, CROP_SIZE = 4, 1024, 512  # crop_and_mask: 4 rendered 1024^2 faces at --size 512
# a mask pixel of crop_and_mask may differ between the card and the CPU only
# where the CPU's top two BiSeNet logits are this close (the card's landmarks,
# crops and convolutions round otherwise; the maps hold >= 0.9999 equal): over
# 10x the widest tie that flipped on an H100 (8.46e-6), ~1000x below the
# median margin (0.104)
CROP_TIE = 1e-4


def phase_dift_kernels() -> dict:
    """K1, K2 and K9 at DIFT's batch (b = 2: target and source at 512^2), K3 at
    DIFT's VAE encode (bf16, b = 2) and at VQ's round trip (fp32, b = 1),
    against their plain versions, timed; returns the rows, which join each
    kernel's row list."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    return {"flash_attention": k1_rows(2, randn), "geglu_ff": ff_rows("geglu_ff", 2, randn),
            "geglu_ff_wide": ff_rows("geglu_ff_wide", 2, randn),
            "gn_sums": [gn_row(randn(2, 128, 512, 512), path="dift"), gn_row(randn(2, 512, 128, 128), path="dift"),
                        gn_row(torch.randn((1, 256, 512, 512), generator=gen, device=dev), path="vq"),
                        gn_row(torch.randn((1, 512, 128, 128), generator=gen, device=dev), path="vq")]}


def _gate(name: str, got, want, tol: float = AUX_GATE_TOL) -> dict:
    """{name_max_abs, name_peak}; fails when ``got`` is over ``tol`` of ``want``'s peak (at least 1) from it."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    peak = max(1.0, float(want.float().abs().max()))
    if not err <= tol * peak:
        raise SystemExit(f"chip_smoke: {name} on the card is {err:.3e} from the CPU's (limit {tol} of {peak:.3f})")
    return {f"{name}_max_abs": f"{err:.3e}", f"{name}_peak": f"{peak:.3f}"}


def phase_dift_vq(model, seed: int) -> None:
    """Phase dift_vq. DIFT (``vface_torch.preprocess.dift``) at full width on
    the ``video`` phase's bf16 SD-v1 model: ``make_prior`` on two seeded
    ``render_face`` faces at 512^2 with the null conditioning (the learnable
    uncond vector), after a warm-up that holds every K1, K2, K9 and K3 call at
    its signature to its plain version; counters reset just before the timed
    call and read after it (each of the four launched); the features
    (``dift_features``, block -4) with the kernels against the plain versions
    within ``DIFT_TOL`` relative L2, and the share of equal correspondences
    (reported). ``VQModel(VQConfig())`` (fp32, seeded, a standard-normal
    codebook): a warm-up round trip that holds every K3 call at its signature
    to its plain version, then one 512^2 image encoded, quantised and decoded, seconds, peak
    memory, K3's launches, the share of the codebook used. The tiny fp32 DIFT
    and VQ, card against CPU within ``AUX_GATE_TOL`` of each output's peak."""
    import copy

    import numpy as np
    import torch

    from vface_torch.models.ldm import ModelConfig, VFaceModel
    from vface_torch.models.vq import VQConfig, VQModel
    from vface_torch.preprocess.dift import correspondences, dift_features, make_prior
    from vface_torch.preprocess.synthetic_faces import render_face
    from vface_torch.utils.convert import init_params

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 80)
    tar, src = (torch.from_numpy(render_face(rng, DIFT_SIZE)[0] * 2 - 1).float().cuda() for _ in range(2))
    cond = model.uncond(2)
    with checked_sites("dift"):
        make_prior(model, tar, src, cond)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    prior = make_prior(model, tar, src, cond)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    both = torch.stack([tar, src])
    feats = dift_features(model, both, cond)
    with plain_kernels():
        feats_plain = dift_features(model, both, cond)
    rel = _rel_l2(feats.float(), feats_plain.float())
    same = float((correspondences(feats[0], feats[1]) == correspondences(feats_plain[0], feats_plain[1]))
                 .all(dim=-1).float().mean())
    log("dift", size=DIFT_SIZE, batch=2, block=-4, feature_hw=f"{feats.shape[1]}x{feats.shape[2]}",
        channels=int(feats.shape[-1]), wall_s=f"{wall:.3f}", peak_gib=f"{peak:.2f}",
        **{k: launches[k] for k in SWAP_KERNELS}, feature_rel_l2_vs_plain=f"{rel:.3e}", tol=DIFT_TOL,
        equal_correspondences=f"{same:.4f}")
    if not (tuple(prior.shape) == (DIFT_SIZE, DIFT_SIZE, 3) and bool(torch.isfinite(prior).all())
            and float(prior.abs().max()) <= 1.0):
        raise SystemExit("chip_smoke: the DIFT prior has the wrong shape, is not finite or leaves [-1, 1]")
    missing = [k for k in SWAP_KERNELS if launches[k] == 0]
    if missing or not rel <= DIFT_TOL:
        raise SystemExit(f"chip_smoke: make_prior launched no {missing}, or its features are {rel:.3e} "
                         f"from the plain path's (limit {DIFT_TOL})")
    del feats, feats_plain, prior, both

    # VQ: the full first stage at 512^2, fp32
    g = torch.Generator(device="cuda").manual_seed(seed + 81)
    with torch.device("cuda"):
        vq = _seeded_(VQModel(VQConfig()), g).eval()
    with torch.no_grad():
        vq.quantize.embedding.copy_(torch.randn(vq.quantize.embedding.shape, generator=g, device="cuda"))
    x = (torch.from_numpy(render_face(rng, DIFT_SIZE)[0] * 2 - 1).float().cuda())[None]
    with torch.inference_mode():
        with checked_sites("vq", expect=("gn_sums",)):
            vq(x)  # warm-up: every K3 signature of the round trip against its plain version
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        h = vq.encode(x)
        quant, loss, idx = vq.quantize(h)
        rec = vq.decode(quant, force_not_quantize=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gn = kernel_counts()["gn_sums"]
    log("vq", size=DIFT_SIZE, n_embed=vq.cfg.n_embed, dtype="float32", wall_s=f"{wall:.3f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", gn_sums=gn,
        codes_used=int(idx.unique().numel()), loss=f"{float(loss):.4f}")
    if gn == 0 or tuple(rec.shape) != (1, DIFT_SIZE, DIFT_SIZE, 3) or not bool(torch.isfinite(rec).all()):
        raise SystemExit("chip_smoke: the VQ round trip launched no K3, or its output has the wrong shape or is not finite")
    del vq, x, h, quant, rec
    torch.cuda.empty_cache()

    # the tiny fp32 DIFT and VQ, card against CPU
    cfg = ModelConfig.tiny(image_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    gt = torch.Generator().manual_seed(seed + 82)
    imgs = torch.rand((2, 32, 32, 3), generator=gt) * 2 - 1
    tcond = torch.randn((2, 1, cfg.unet.context_dim), generator=gt)
    noise = torch.randn((2, cfg.latent_size, cfg.latent_size, 4), generator=gt)
    vq_cpu = _seeded_(VQModel(VQConfig.tiny()), torch.Generator().manual_seed(seed + 83)).eval()
    with torch.no_grad():
        vq_cpu.quantize.embedding.copy_(torch.randn(vq_cpu.quantize.embedding.shape, generator=gt))
    outs = {}
    for dev in ("cpu", "cuda"):
        m = VFaceModel(cfg, device=dev)
        m.load_params(params)
        f = dift_features(m, imgs.to(dev), tcond.to(dev), noise=noise.to(dev), block=-1)
        v = vq_cpu if dev == "cpu" else copy.deepcopy(vq_cpu).to(dev)
        with torch.inference_mode():
            hq = v.encode(imgs.to(dev))
            rec, _ = v(imgs.to(dev))
            idx = v.quantize(hq)[2]
        outs[dev] = dict(features=f.cpu(), corr=correspondences(f[0], f[1]).cpu(), latent=hq.cpu(), rec=rec.cpu(),
                         idx=idx.cpu())
    c, g_ = outs["cuda"], outs["cpu"]
    fields = {**_gate("dift_features", c["features"], g_["features"]), **_gate("vq_latent", c["latent"], g_["latent"]),
              **_gate("vq_reconstruction", c["rec"], g_["rec"])}
    log("dift_vq_gate", config="tiny fp32 (ModelConfig.tiny(32), VQConfig.tiny())", **fields, tol=AUX_GATE_TOL,
        equal_correspondences=f"{float((c['corr'] == g_['corr']).all(dim=-1).float().mean()):.4f}",
        equal_codes=f"{float((c['idx'] == g_['idx']).float().mean()):.4f}")
    log("dift_vq_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


def _text_tokenizer():
    """The port's tokenizer on a synthetic vocabulary (the byte alphabet and its
    ``</w>`` forms, a few merges, BOS / EOS last), as the CPU tests build it."""
    from vface_torch.models.clip_tokenizer import BOS, EOS, CLIPBPETokenizer, byte_alphabet

    alpha = list(byte_alphabet().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"), ("hell", "o</w>"), ("t", "h"), ("th", "e</w>"),
              ("a", "</w>"), ("f", "a"), ("fa", "c"), ("fac", "e</w>")]
    vocab = {}
    for tok in alpha + [a + "</w>" for a in alpha]:
        vocab.setdefault(tok, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return CLIPBPETokenizer(vocab, merges)


def phase_aux_clis(seed: int) -> None:
    """Phase aux_clis: the modules and CLIs the port added last, on the card.
    CLIP text: ``CLIPTextEncoder(CLIPTextConfig())`` (ViT-L/14 text geometry,
    fp32, seeded; EOS at the synthetic vocabulary's id) on a 2 x 77 batch from
    the port's tokenizer (synthetic vocabulary, padded to 77), card against
    CPU within ``AUX_GATE_TOL``. face-vid2vid: the ``driven_demo`` CLI in
    process at ``FV2VConfig()`` (256^2, 15 keypoints, depth 16) on a written
    8-frame 256^2 Y4M of ``render_face`` faces with a seeded ``--params``
    npz: wall seconds, seconds a frame (load and build included), peak
    memory; one generator frame on the card against the CPU within
    ``AUX_GATE_TOL``. ``crop_and_mask`` in process on 4 rendered 1024^2 faces
    at ``--size 512`` on the card and on the CPU: crops within 1 uint8 level,
    masks equal but at pixels where the CPU's top two BiSeNet logits lie
    within ``CROP_TIE`` (at least 0.9999 of each map equal)."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vface_torch.io.image import read_png, write_png
    from vface_torch.io.video import write_y4m
    from vface_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from vface_torch.models.bisenet import parsing_preprocess
    from vface_torch.models.face_vid2vid import FV2VConfig, OcclusionAwareGenerator, init_params as fv2v_init
    from vface_torch.preprocess.align import compute_quad, quad_crop
    from vface_torch.preprocess.synthetic_faces import render_face
    from vface_torch.scripts import crop_and_mask, driven_demo

    t_phase = time.perf_counter()
    # CLIP text at ViT-L/14 text geometry
    t0 = time.perf_counter()
    tok = _text_tokenizer()
    batch = tok(["a photo of the face", "naïve café 中文 — hello, hello!"], max_length=77, padding="max_length")
    tok_s = time.perf_counter() - t0
    cfg = CLIPTextConfig(eos_token_id=tok.eos_id)
    g = torch.Generator().manual_seed(seed + 90)
    enc = _seeded_(CLIPTextEncoder(cfg), g).eval()
    with torch.no_grad():
        for p in (enc.text.token_embedding, enc.text.position_embedding):
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    ids, mask = torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"])
    with torch.inference_mode():
        want = enc(ids, pad_mask=mask)
        card = copy.deepcopy(enc).cuda()
        card(ids.cuda(), pad_mask=mask.cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card(ids.cuda(), pad_mask=mask.cuda())
        torch.cuda.synchronize()
        text_s = time.perf_counter() - t0
    fields = {}
    for name, a, b in zip(("hidden", "pooled", "projected"), got, want):
        fields.update(_gate(f"clip_text_{name}", a, b))
    log("clip_text", config="CLIPTextConfig() fp32 (ViT-L/14 text)", batch="2x77", tokenizer_s=f"{tok_s:.3f}",
        tokens=",".join(str(int(m.sum())) for m in mask), forward_s=f"{text_s:.4f}", **fields, tol=AUX_GATE_TOL)
    del card, enc

    root = tempfile.mkdtemp(prefix="vface_aux_")
    try:
        # face-vid2vid through its CLI at full size
        fcfg = FV2VConfig()
        gen = fv2v_init(OcclusionAwareGenerator(fcfg), torch.Generator().manual_seed(seed + 91)).eval()
        np.savez(os.path.join(root, "fv2v.npz"), **flax_npz_arrays("", gen.state_dict()))
        rng = np.random.default_rng(seed + 92)
        s = fcfg.image_size
        frames = np.stack([(np.clip(render_face(rng, s)[0], 0, 1) * 255).astype(np.uint8) for _ in range(AUX_FRAMES)])
        write_y4m(os.path.join(root, "drive.y4m"), frames, fps=10)
        src_u8 = (np.clip(render_face(rng, s)[0], 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(root, "src.png"), src_u8)
        run = run_image_cli(driven_demo, ["--source", os.path.join(root, "src.png"), "--driving",
                                          os.path.join(root, "drive.y4m"), "--out", os.path.join(root, "d.avi"),
                                          "--params", os.path.join(root, "fv2v.npz"), "--size", str(s)])
        avi = os.path.getsize(os.path.join(root, "d.avi"))
        if f"{AUX_FRAMES} frames" not in run["out"] or avi < AUX_FRAMES * s * s * 3:
            raise SystemExit(f"chip_smoke: driven_demo wrote {avi} bytes: {run['out'][-200:]}")
        src01 = torch.from_numpy(src_u8.astype(np.float32) / 255.0)[None]
        drv01 = torch.from_numpy(frames[3].astype(np.float32) / 255.0)[None]
        with torch.inference_mode():
            want = gen(src01, drv01)
            card = copy.deepcopy(gen).cuda()
            got = card(src01.cuda(), drv01.cuda())
            kp = card.extract_kp(src01.cuda())
            kp_cpu = gen.extract_kp(src01)
        log("fv2v", config="FV2VConfig() (256^2, 15 keypoints, depth 16)", frames=AUX_FRAMES,
            wall_s=f"{run['wall_s']:.3f}", s_per_frame=f"{run['wall_s'] / AUX_FRAMES:.4f}",
            peak_gib=f"{run['peak_gib']:.2f}", avi_bytes=avi, **_gate("fv2v_frame", got, want),
            **_gate("fv2v_keypoints", kp, kp_cpu), tol=AUX_GATE_TOL, note="wall: the CLI's whole run, build and load included")
        del card, gen

        # crop_and_mask on rendered faces, card against CPU
        faces = os.path.join(root, "faces")
        os.makedirs(faces)
        for i in range(CROP_FACES):
            write_png(os.path.join(faces, f"f{i}.png"),
                      (np.clip(render_face(rng, CROP_FRAME)[0], 0, 1) * 255).astype(np.uint8))
        argv = ["--indir", faces, "--size", str(CROP_SIZE)]
        card_run = run_image_cli(crop_and_mask, argv + ["--outdir", os.path.join(root, "card")])
        os.environ["VFACE_PLATFORM"] = "cpu"
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee()):
                if crop_and_mask.main(argv + ["--outdir", os.path.join(root, "cpu")]) != 0:
                    raise SystemExit("chip_smoke: crop_and_mask on the CPU failed")
            cpu_s = time.perf_counter() - t0
        finally:
            os.environ.pop("VFACE_PLATFORM", None)
        # the CPU's BiSeNet logits on its own crops: a mask pixel may differ only at a class tie
        nets = crop_and_mask.aux_nets(("landmark", "bisenet"), device="cpu")
        files = crop_and_mask.image_files(faces)
        with torch.inference_mode():
            imgs = crop_and_mask.load_batch(faces, files, "cpu")
            crops = quad_crop(imgs, compute_quad(nets["landmark"](imgs))[0], CROP_SIZE)
            top2 = nets["bisenet"](parsing_preprocess(crops, CROP_SIZE)).topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).numpy()
        mask_same, crop_diff, tie = [], 0, 0.0
        for i, f in enumerate(files):
            rd = lambda side, kind: read_png(os.path.join(root, side, kind, f)).astype(np.int32)
            differ = rd("card", "masks") != rd("cpu", "masks")
            mask_same.append(float(1.0 - differ.mean()))
            tie = max(tie, float(margin[i][differ].max()) if differ.any() else 0.0)
            crop_diff = max(crop_diff, int(np.abs(rd("card", "crops") - rd("cpu", "crops")).max()))
        log("crop_and_mask", faces=CROP_FACES, frame=f"{CROP_FRAME}^2", size=CROP_SIZE, wall_s=f"{card_run['wall_s']:.3f}",
            cpu_s=f"{cpu_s:.3f}", peak_gib=f"{card_run['peak_gib']:.2f}",
            equal_mask_share=",".join(f"{v:.6f}" for v in mask_same), differing_max_logit_margin=f"{tie:.3e}",
            tie_tol=CROP_TIE, logit_margin_median=f"{float(np.median(margin)):.3e}", crop_max_levels=crop_diff)
        if min(mask_same) < 0.9999 or tie > CROP_TIE or crop_diff > 1:
            raise SystemExit(f"chip_smoke: crop_and_mask on the card: masks {mask_same} equal to the CPU's (pixels "
                             f"that differ within {tie:.3e} of a class tie, limit {CROP_TIE}), crops {crop_diff} "
                             "levels apart")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("aux_clis_phase", wall_s=f"{time.perf_counter() - t_phase:.3f}")


# ---- phase hires: SD-v1 above 512^2, where the ds4 self-attention (C 1280,
# 8 heads: dh 160) has N >= 576 tokens and takes the attention kernels
HIRES_DH = 160
HIRES_IMAGE = 1024  # the image swap: ds4 has 1024 tokens
HIRES_WINDOW = 768  # the video window and the train step: ds4 has 576 tokens
HIRES_IMAGE_STEPS = 10
HIRES_WINDOW_STEPS = 8  # inversion and sampling, cut from 50 + 50 for time
HIRES_TOL = 3e-2  # relative L2, kernel path against the plain one at bf16 (as train_reference and dift_vq)
HIRES_F32_TOL = 1e-3  # the fp32 UNet eval, kernel path against the plain one (as phase fp32_unet)


def wide_launches() -> dict:
    """The attention kernels' launches at ``HIRES_DH`` since the last reset,
    as {kernel@dh160: count}."""
    from vface_torch.ops import flash_attention as FA

    return {f"{k}@dh{dh}": v for (k, dh), v in sorted(FA.DH_LAUNCHES.items()) if dh == HIRES_DH}


def _f32_fwd_rows(rows: dict, b: int, n: int, c: int, h: int, randn) -> None:
    """The tf32 kernel's forms on fp32 operands at (b, n, c), h heads: K8
    (``flash_attention_v1``), K4 (``flash_attention_stats``), K6
    (``flash_attention_fp32``) and K7 (``flash_attention_v2_stats``). All four
    compute one function at fp32 (K4's P rounding is a no-op there) on one
    kernel: their outputs are equal bit for bit, within 1e-5 of the peak of
    the plain version (three tf32 terms per product, other sums), m and l
    (K4, K7) within 1e-5 relative. Bound: the 3xTF32 line
    (:func:`tf32x3_bound`), the FFMA line on the log line; library: SDPA on
    fp32."""
    import torch
    import torch.nn.functional as F

    from vface_torch.ops import flash_attention as FA

    dh = c // h
    q, k, v = (randn(b, n, c, dtype=torch.float32) for _ in range(3))
    shape = _shape(b, n, n, c, h) + " fp32"
    want, wm, wl = FA.flash_attention_stats_ref(q, k, v, h)
    outs = {"flash_attention_v1": (FA._flash_attention_v1(q, k, v, h),),
            "flash_attention_stats_f32": FA.flash_attention_stats(q, k, v, h),
            "flash_attention_fp32_f32": (FA.flash_attention_fp32(q, k, v, h),),
            "flash_attention_v2_stats": FA.flash_attention_v2_stats(q, k, v, h)}
    torch.cuda.synchronize()
    first = outs["flash_attention_v1"][0]
    same = all(torch.equal(o[0], first) for o in outs.values())
    rel_ml = max(max(((o[1] - wm).abs() / wm.abs().clamp(min=1e-30)).max().item(),
                     ((o[2] - wl).abs() / wl).max().item()) for o in outs.values() if len(o) == 3)
    log("kernel_f32_forms_check", shape=shape.replace(" ", "_"), equal_bitwise=same,
        m_l_max_rel_err=f"{rel_ml:.3e}", tol="1e-05")
    if not (same and rel_ml <= 1e-5):
        raise SystemExit(f"chip_smoke: the tf32 kernel's forms disagree at {shape}")
    calls = {"flash_attention_v1": lambda: FA._flash_attention_v1(q, k, v, h),
             "flash_attention_stats_f32": lambda: FA.flash_attention_stats(q, k, v, h),
             "flash_attention_fp32_f32": lambda: FA.flash_attention_fp32(q, k, v, h),
             "flash_attention_v2_stats": lambda: FA.flash_attention_v2_stats(q, k, v, h)}
    replaces = {"flash_attention_v1": 44, "flash_attention_stats_f32": 658, "flash_attention_fp32_f32": 143,
                "flash_attention_v2_stats": 302}
    split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
    plain_ms = cuda_ms(lambda: FA.flash_attention_stats_ref(q, k, v, h), reps=3, warmup=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)))
    flops = 4.0 * b * h * n * n * dh
    for name, call in calls.items():
        stats = len(outs[name]) == 3
        nbytes = 4 * q.numel() * 4 + (2 * b * h * n * 4 if stats else 0)
        rows.setdefault(name, []).append(_row(
            name, "cuda", "vface_torch/csrc/flash_attention_f32.cu", f"vface_tpu/ops/pallas_attention.py:{replaces[name]}",
            _errs(outs[name][0], want), ("rel", 1e-5), cuda_ms(call), plain_ms, lib_ms,
            tf32x3_bound(flops, nbytes, b * h * n * n), shape, ffma=ffma_ms(flops)))
    del q, k, v, outs, want, wm, wl


def phase_hires_kernels() -> dict:
    """The attention kernels at SD-v1's ds4 head width (C 1280, 8 heads: dh
    160) against their plain versions, at the shapes phase hires gives them;
    returns the rows. K1 at (2, 1024) and (8, 1024) (the 1024^2 image swap at
    b = 1 and the test bench's b = 4, CFG doubling both) and at (6, 576) and
    (12, 576) (the 768^2 window's inversion and sampling), 2 bf16 ulps as
    :func:`k1_rows`; K4, K6 and K5 at b = 1 over 576 and 1024 tokens (the
    train step), gated as :func:`phase_train_kernels`; K7 at bf16 at (1,
    1024), gated as :func:`phase_ops_kernels` (m and l, K6's output bit for
    bit, 2 ulps, the precision gate); the fp32 forms (K8, K4, K6, K7 on the
    tf32 kernel) at (1, 1024) and (12, 576), :func:`_f32_fwd_rows`; K5 on fp32
    at b = 1 over 576 and 1024 tokens (an fp32 train step's), :func:`_bwd_f32_row`."""
    import torch

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device=dev).to(dtype)
    c, h = 1280, 8
    rows = {"flash_attention": [], "flash_attention_stats": [], "flash_attention_fp32": [],
            "flash_attention_bwd": [], "flash_attention_v2_stats": []}
    for b, n in ((2, 1024), (8, 1024), (6, 576), (12, 576)):
        rows["flash_attention"] += k1_rows(b, randn, ((n, c),))
    for n in (576, 1024):
        _train_rows(rows, 1, n, n, c, h, randn)
    _k7_bf16_row(rows, 1, 1024, 1024, c, h, randn)  # K7 at bf16: K6's kernel with the stats epilogue
    for b, n in ((1, 1024), (12, 576)):
        _f32_fwd_rows(rows, b, n, c, h, randn)
    rows["flash_attention_bwd_f32"] = []
    for n in (576, 1024):
        _bwd_f32_row(rows, 1, n, n, c, h, lambda *s: randn(*s, dtype=torch.float32))
    log("hires_kernels", wall_s=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def at_image_size(model, size: int):
    """The model with its config's image size (and so its latent size) set to ``size``."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, image_size=size)
    try:
        yield model
    finally:
        model.cfg = cfg


def _check_wide(name: str, launches: dict, kernels: tuple) -> dict:
    """The launches at dh 160 of ``kernels`` in a run; fails if one has none."""
    wide = wide_launches()
    missing = [k for k in kernels if not wide.get(f"{k}@dh{HIRES_DH}")]
    if missing:
        raise SystemExit(f"chip_smoke: phase hires's {name} launched no {missing} at dh {HIRES_DH}")
    return wide


def phase_hires(model, seed: int) -> None:
    """Phase hires on the video phase's model (bf16, with the conditioner)
    above 512^2, where the UNet's ds4 self-attention (dh 160) takes the
    attention kernels, counts set to 0 before and read after each run:
    (b) ``swap_image_batch`` at ``HIRES_IMAGE``^2 (latent 128^2), b = 1,
    ``HIRES_IMAGE_STEPS`` DDIM steps, scale 3.0, with the kernels and with the
    plain versions (:func:`plain_kernels`) on the same inputs: relative L2
    within ``HIRES_TOL``, K1's launches at dh 160, seconds per stage, peak
    memory; (c) ``swap_window`` on 6 frames at ``HIRES_WINDOW``^2 crops,
    ``HIRES_WINDOW_STEPS`` + ``HIRES_WINDOW_STEPS`` steps under
    :func:`checked_sites` (every K1, K2, K9 and K3 call held to its plain
    version at each new signature): seconds per stage, peak memory, launches
    at dh 160; (d) one bf16 train step (``p_losses_face`` + backward on fixed
    draws) at ``HIRES_WINDOW``^2, b = 1, with the kernels and with the plain
    versions: the UNet gradients within phase train_reference's 3e-2, K4, K6
    and K5's launches at dh 160, seconds, peak memory. The fp32 eval at
    ``HIRES_WINDOW``^2 runs in :func:`phase_fp32_unet`, on its model."""
    import torch

    from vface_torch.pipelines.image_swap import ImageSwapOptions, swap_image_batch
    from vface_torch.pipelines.train import TrainConfig
    from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

    t_phase = time.perf_counter()
    rel = lambda a, w: float((a.float() - w.float()).norm() / w.float().norm())

    def measured(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernel_counts(), torch.cuda.max_memory_allocated() / 2**30

    with at_image_size(model, HIRES_IMAGE):  # (b)
        s = HIRES_IMAGE
        x = image_inputs(model, 1, seed + 60)
        args = [x[k] for k in ("target", "keep", "src_clip", "src01", "lms")]
        opts = ImageSwapOptions(HIRES_IMAGE_STEPS, 3.0)
        timings = {}
        out, wall, launches, peak = measured(lambda: swap_image_batch(model, *args, opts, timings=timings))
        wide = _check_wide("image swap", launches, ("flash_attention",))
        with plain_kernels():
            want = swap_image_batch(model, *args, opts)
        err = rel(out, want)
        ok = tuple(out.shape) == (1, s, s, 3) and bool(torch.isfinite(out).all()) and 0 <= float(out.min()) \
            and float(out.max()) <= 1
        log("hires_image", image=f"{s}^2", latent=f"{model.cfg.latent_size}^2", batch=1, unet_batch=2,
            ddim_steps=HIRES_IMAGE_STEPS, wall_s=f"{wall:.3f}", **stage_line(timings), peak_gib=f"{peak:.2f}",
            rel_l2_vs_plain=f"{err:.3e}", tol=HIRES_TOL, **{k: v for k, v in launches.items() if v}, **wide)
        if not (ok and err <= HIRES_TOL):
            raise SystemExit("chip_smoke: the 1024^2 image swap is malformed or disagrees with its plain path")
        del x, args, out, want

    with at_image_size(model, HIRES_WINDOW):  # (c)
        frames, n = FRAMES, HIRES_WINDOW_STEPS
        opts = SwapOptions(ddim_steps=n, inversion_steps=n, window=frames, image_size=HIRES_WINDOW)
        inputs = window_inputs(model, frames, seed + 61)
        timings = {}
        with checked_sites("hires_window"):
            out, wall, launches, peak = measured(lambda: VideoSwapPipeline(model, opts, device="cuda").swap_window(
                **inputs, timings=timings))
        wide = _check_wide("window", launches, ("flash_attention",))
        ok = (tuple(out.shape) == (frames, HIRES_WINDOW, HIRES_WINDOW, 3) and bool(torch.isfinite(out).all())
              and float(out.min()) >= 0.0 and float(out.max()) <= 1.0)
        log("hires_window", frames=frames, image=f"{HIRES_WINDOW}^2", ddim_steps=n, inversion_steps=n,
            wall_s=f"{wall:.3f}", **{f"{k}_s": f"{v:.3f}" for k, v in timings.items()}, peak_gib=f"{peak:.2f}",
            **{k: v for k, v in launches.items() if v}, **wide)
        if not ok:
            raise SystemExit("chip_smoke: the 768^2 window's output has the wrong shape, is not finite or leaves [0, 1]")
        del inputs, out

        cfg = TrainConfig()  # (d)
        batch, fixed = train_batch(model, 1, seed + 62), _train_fixed(model, 1, seed + 63)
        (logs_k, grads_k), wall, launches, peak = measured(lambda: _loss_grads(model, batch, fixed, cfg))
        wide = _check_wide("train step", launches,
                           ("flash_attention_stats", "flash_attention_fp32", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv"))
        with plain_kernels():
            logs_p, grads_p = _loss_grads(model, batch, fixed, cfg)
        model.zero_grad(set_to_none=True)
        names = [k for k in grads_p if k.startswith("unet.")]
        diff = math.sqrt(sum(float((grads_k[k].float() - grads_p[k].float()).norm()) ** 2 for k in names))
        ref = math.sqrt(sum(float(grads_p[k].float().norm()) ** 2 for k in names))
        finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
        log("hires_train", image=f"{HIRES_WINDOW}^2", batch=1, wall_s=f"{wall:.3f}", peak_gib=f"{peak:.2f}",
            unet_grad_rel_l2=f"{diff / ref:.3e}", tol=3e-2, loss_kernels=f"{logs_k['loss']:.6f}",
            loss_plain=f"{logs_p['loss']:.6f}", finite=finite, **{k: v for k, v in launches.items() if v}, **wide)
        del grads_k, grads_p
        if not (finite and diff / ref <= 3e-2):
            raise SystemExit("chip_smoke: the 768^2 train step's gradients disagree with the plain path")
    torch.cuda.empty_cache()
    log("hires_phase", wall_s=f"{time.perf_counter() - t_phase:.1f}")


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
    clock = lambda after: log("clock", after=after, t_s=f"{time.perf_counter() - t_script:.1f}")

    import torch

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build()
    clock("build")
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
    for name, more in phase_dift_kernels().items():  # and at DIFT's b = 2, K3 at DIFT's and VQ's VAEs
        rows[name] += more
    for name, more in phase_hires_kernels().items():  # the attention kernels at ds4's dh 160 (phase hires)
        rows.setdefault(name, []).extend(more)
    bench_launches = phase_bench(args.bench_reps)
    clock("kernels")
    model = build_model(SEED)
    launches = phase_swap(model, FRAMES, DDIM_STEPS, INVERSION_STEPS, SEED)
    phase_reference(model, FRAMES, SEED)
    phase_small_reference(SEED)
    phase_small_video_reference(SEED)
    ops_launches = phase_ops(model, FRAMES, SEED)
    clock("swap_references_ops")
    if args.profile:
        phase_profile(model, FRAMES, SEED, args.profile)
    del model  # serving's swap_window needs no conditioner; the video path and training do
    torch.cuda.empty_cache()
    f32_launches = phase_fp32_unet(smi, FRAMES, SEED)
    clock("fp32_unet")
    model = build_model(SEED, conditioner=True)
    phase_video(model, SEED)
    clock("video")
    torch.cuda.empty_cache()
    base = phase_sched(model, SEED)
    clock("sched")
    torch.cuda.empty_cache()
    phase_opts(model, SEED, base)
    clock("opts")
    torch.cuda.empty_cache()
    phase_multiface(model, SEED, base)
    clock("multiface")
    torch.cuda.empty_cache()
    phase_dift_vq(model, SEED)
    clock("dift_vq")
    phase_aux_clis(SEED)
    clock("aux_clis")
    phase_eval(SEED, base)
    clock("eval")
    del base
    torch.cuda.empty_cache()
    phase_image(model, SEED)
    clock("image")
    torch.cuda.empty_cache()
    phase_hires(model, SEED)
    clock("hires")
    torch.cuda.empty_cache()
    train_launches = phase_train(model, SEED)
    phase_train_reference(model, SEED)
    if args.profile_train:
        phase_profile_train(model, SEED, args.profile_train)
    phase_train_terms(model, SEED)
    phase_vae_train(model, SEED)
    clock("train_phases")
    del model  # the training CLI, the fp32 gate and the video CLI build their own models
    torch.cuda.empty_cache()
    phase_train_cli(SEED, phase_mesh_train(SEED))  # the CLI resumes the ranks' last
    clock("mesh_train_train_cli")
    phase_racecheck()
    clock("racecheck")
    phase_sched_gate(SEED)
    clock("sched_gate")
    phase_mesh_gate(SEED)
    clock("mesh_gate")
    phase_cli(SEED)
    clock("cli")
    phase_image_cli(SEED)
    clock("image_cli")
    launches.update({k: v for k, v in train_launches.items() if k not in SWAP_KERNELS})
    launches.update({k: ops_launches[k] for k in OPS_KERNELS})
    launches.update({k: bench_launches[k] for k in BENCH_KERNELS})
    launches.update({k: f32_launches[k] for k in ("flash_attention_bwd_dq_f32", "flash_attention_stats_f32",
                                                  "flash_attention_fp32_f32", "geglu_ff_f32", "geglu_ff_wide_f32")})
    log("script", wall_s=f"{time.perf_counter() - t_script:.1f}")
    print(smi, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
