"""The attention forward at ds4's head width on the card, beside SDPA.

Times the forward kernels at SD-v1's ds4 self-attention above 512^2 (C 1280,
h 8: dh 160): on bf16, K1 (``flash_attention``), K4
(``flash_attention_stats``) and K6 (``flash_attention_fp32``) at (2, 1024)
and (8, 1024) (a 1024^2 image swap at b = 1 and the test bench's b = 4, CFG
doubling both) and at (6, 576) and (12, 576) (a 768^2 window's inversion and
sampling); on fp32, the tf32 kernel's forms K8, K4, K6 and K7 at (1, 1024) (a
train step's) and (12, 576) (a 768^2 window's sampling batch). SDPA on the same
operands stands beside each case (the library's time for the same
function). The same entries at ds1 and ds2 (dh 40: (12, 4096, 320) bf16,
(1, 4096, 320) fp32; dh 80: (12, 1024, 640) bf16, (1, 1024, 640) fp32)
guard the kernels that a change at dh 160 must leave as they are. It has no
JAX counterpart: it compares two trees' kernels, run once from inside each
tree in one call (parent, change, change, parent), through the wrappers both
trees have.

Each time is the median of ``--runs`` runs of ``--reps`` calls after one
warm-up call: by CUDA events around the calls (``ms``: the wrappers' host
dispatch included) and by the time in which the card runs any kernel the
calls launch (``device ms``: torch.profiler's kernel intervals, overlapping
ones counted once; NaN where the profiler shows none). Run:
``python -m vface_torch.bench.attn_fwd_wide [--reps N] [--runs N] [--only
TEXT ...]`` (``--only``: the cases whose title holds one of the texts, e.g.
``"dh160 bf16"``); the last line is one JSON object {"device": name, "ms":
{"entry (b,n,c) dtype": ms}, "device_ms": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from vface_torch.bench import cuda_ms, randn, report
from vface_torch.bench.attn_bwd_wide import device_ms
from vface_torch.bench.attn_f32 import sdpa
from vface_torch.ops import flash_attention as FA

H = 8
BF16_WIDE = ((2, 1024, 1280), (8, 1024, 1280), (6, 576, 1280), (12, 576, 1280))
F32_WIDE = ((1, 1024, 1280), (12, 576, 1280))
BF16_GUARD = ((12, 4096, 320), (12, 1024, 640))  # dh 40 and 80
F32_GUARD = ((1, 4096, 320), (1, 1024, 640))
BF16_ENTRIES = {"K1 flash_attention": FA.flash_attention, "K4 flash_attention_stats": FA.flash_attention_stats,
                "K6 flash_attention_fp32": FA.flash_attention_fp32, "SDPA": sdpa}
# K8 through its kernel's wrapper: the public flash_attention_v1 takes the
# plain path where N is not a multiple of its 256-row blocks (576)
F32_ENTRIES = {"K8 flash_attention_v1": FA._flash_attention_v1, "K4 flash_attention_stats": FA.flash_attention_stats,
               "K6 flash_attention_fp32": FA.flash_attention_fp32,
               "K7 flash_attention_v2_stats": FA.flash_attention_v2_stats, "SDPA": sdpa}
CASES = tuple((case, torch.bfloat16, BF16_ENTRIES) for case in BF16_WIDE + BF16_GUARD) + tuple(
    (case, torch.float32, F32_ENTRIES) for case in F32_WIDE + F32_GUARD)


def title(b: int, n: int, c: int, dtype) -> str:
    return f"({b},{n},{c}) h{H} dh{c // H} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"


def run(reps: int = 50, runs: int = 3, device="cuda", only=()):
    """Time every entry at every case (whose title holds one of ``only``, if
    given); returns ({case title: {entry: median ms}}, the same of device ms)."""
    out, dev = {}, {}
    for (b, n, c), dtype, entries in CASES:
        key = title(b, n, c, dtype)
        if only and not any(text in key for text in only):
            continue
        q, k, v = (randn((b, n, c), seed=s, device=device, dtype=dtype) for s in range(3))
        with torch.inference_mode():
            calls = {name: (lambda fn=fn: fn(q, k, v, H)) for name, fn in entries.items()}
            out[key] = {name: statistics.median(cuda_ms(fn, reps) for _ in range(runs)) for name, fn in calls.items()}
            dev[key] = {name: statistics.median(device_ms(fn, reps) for _ in range(runs))
                        for name, fn in calls.items()}
        del q, k, v, calls
        torch.cuda.empty_cache()
    return out, dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=())
    args = ap.parse_args(argv)
    out, dev = run(args.reps, args.runs, only=args.only)
    for key, results in out.items():
        report(key, {name: f"{ms:8.4f} ms, device {dev[key][name]:8.4f} ms" for name, ms in results.items()})
    flat = lambda table: {f"{name} {key}": ms for key, res in table.items() for name, ms in res.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": flat(out), "device_ms": flat(dev)}), flush=True)
    return out


if __name__ == "__main__":
    main()
