"""Kernel benches on the card, the ports of the JAX package's bench scripts.

* :mod:`vface_torch.bench.attention` (``scripts/bench_attention.py``): every
  attention variant at the UNet's self-attention shapes, K10-K12 included;
* :mod:`vface_torch.bench.attn_v56` (``scripts/bench_attn_v56.py``): K1
  against K12 and SDPA at batch 24;
* :mod:`vface_torch.bench.ff_tile` (``scripts/bench_ff_tile.py``): K13's row
  tile sweep against the unfused route, ending with one JSON line;
* :mod:`vface_torch.bench.attn_f32` (no JAX counterpart): the tf32 forward
  kernel's entry points (K8, and K4, K6, K7 on fp32) at the UNet's dh 40 and
  80 beside SDPA, ending with one JSON line, to compare two trees' kernels;
* :mod:`vface_torch.bench.attn_bwd_wide` (no JAX counterpart): K5 on bf16
  and fp32 at ds4's dh 160 (its dQ, dK/dV and split kernels apart, beside
  SDPA's backward) and at dh 40 / 80, by CUDA events and by the profiler's
  device time, ending with one JSON line, to compare two trees' kernels;
* :mod:`vface_torch.bench.attn_fwd_wide` (no JAX counterpart): the forward
  kernels at ds4's dh 160 (K1, K4, K6 on bf16; the tf32 forms on fp32)
  beside SDPA, and at dh 40 / 80 as the guard, timed as attn_bwd_wide.

Run each with ``python -m vface_torch.bench.<name>`` on a CUDA device; times
are CUDA events over ``--reps`` calls after one warm-up call.
"""

from __future__ import annotations

import torch

from vface_torch.utils.platform import resolve_device


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
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


def randn(shape, seed: int, device="cuda", dtype=torch.bfloat16, scale: float = 1.0) -> torch.Tensor:
    """Seeded standard-normal values made on ``device``, times ``scale``, cast to ``dtype``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def report(title: str, results: dict) -> None:
    """Print one bench case: a time in ms, or the reason a variant has none."""
    print(f"\n== {title} ==", flush=True)
    for name, val in results.items():
        print(f"  {name:24s} {val if isinstance(val, str) else f'{val:8.3f} ms'}", flush=True)
