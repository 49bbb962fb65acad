"""K5, the attention backward, on the card at the UNet's head widths.

Times ``flash_attention_bwd`` on bf16 and fp32 operands at SD-v1's ds4
self-attention above 512^2 (dh 160: (1, 576, 1280) at 768^2, (1, 1024, 1280)
at 1024^2, h 8, a train step's batch), each kernel apart: the dQ kernel, the
dK/dV kernel and, on fp32, the split pass that writes the tf32 planes both
read; the whole call; and SDPA's autograd backward on the same inputs (the
library's time for the same function). It also times the whole call at ds1
and ds2 (dh 40: (1, 4096, 320); dh 80: (1, 1024, 640)), whose kernels a change
at dh 160 must leave as they are. It has no JAX counterpart: it compares two
trees' kernels, run once under each tree's ``PYTHONPATH`` in one call
(parent, change, change, parent), through the wrappers both trees have.

Each time is the median of ``--runs`` runs of ``--reps`` calls after one
warm-up call: by CUDA events around the calls (``ms``: the wrappers' host
dispatch included, which at these shapes can exceed the kernels' own time)
and by the time in which the card runs any kernel the calls launch
(``device ms``: torch.profiler's kernel intervals, overlapping ones counted
once; NaN where the profiler shows none). Run:
``python -m vface_torch.bench.attn_bwd_wide [--reps N] [--runs N]``; the last
line is one JSON object {"device": name, "ms": {"entry (b,n,c) dtype": ms},
"device_ms": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch
import torch.nn.functional as F

from vface_torch.bench import cuda_ms, randn, report
from vface_torch.ops import flash_attention as FA

H = 8
WIDE = ((1, 576, 1280), (1, 1024, 1280))  # dh 160: split into its kernels, with SDPA's backward
NARROW = ((1, 4096, 320), (1, 1024, 640))  # dh 40 and 80: the whole call
DTYPES = (torch.bfloat16, torch.float32)


def _inputs(b: int, n: int, c: int, dtype, device):
    """q, k, v, dO and the backward's m, l and D from the forward kernels."""
    q, k, v, do = (randn((b, n, c), seed=s, device=device, dtype=dtype) for s in range(4))
    _, m, l = FA.flash_attention_stats(q, k, v, H)
    dd = FA.rowsum_do_o(do, FA.flash_attention_fp32(q, k, v, H), H)
    return q, k, v, do, m, l, dd


def _entries(q, k, v, do, m, l, dd, split: bool) -> dict:
    """{name: call}: the whole backward and, with ``split``, each kernel apart
    (on a CUDA device) and SDPA's backward; each returns (dq, dk, dv), SDPA's
    in its (B, H, N, dh) layout."""
    entries = {"K5": lambda: FA.flash_attention_bwd(q, k, v, do, m, l, dd, H)}
    if not split:
        return entries
    if q.is_cuda:
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, do, m, l, dd, H)
        stats = (m, l, dd)
        if q.dtype == torch.float32:
            planes = FA._bwd_f32_planes(q, k, v, do, H)
            entries["K5 split"] = lambda: FA._bwd_f32_planes(q, k, v, do, H)
            entries["K5 dQ"] = lambda: FA._launch_bwd_f32("flash_attention_bwd_dq_f32", planes, q, k, H, stats, (dq,))
            entries["K5 dK/dV"] = lambda: FA._launch_bwd_f32("flash_attention_bwd_dkv_f32", planes, q, k, H, stats,
                                                             (dk, dv))
        else:
            entries["K5 dQ"] = lambda: FA._launch_bwd("flash_attention_bwd_dq", "vface_flash_attention_bwd_dq_bf16",
                                                      FA._DQ_ARGS, q, k, v, do, H, stats, (dq,))
            entries["K5 dK/dV"] = lambda: FA._launch_bwd("flash_attention_bwd_dkv",
                                                         "vface_flash_attention_bwd_dkv_bf16", FA._DKV_ARGS, q, k, v,
                                                         do, H, stats, (dk, dv))
    b, n, c = q.shape
    heads = lambda t: t.view(b, n, H, c // H).transpose(1, 2)
    leaves = [heads(t).detach().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    grad = heads(do)
    entries["SDPA backward"] = lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)
    return entries


def device_ms(fn, reps: int) -> float:
    """The time per call in which the card runs a kernel that ``reps`` calls of
    ``fn`` launch (the union of torch.profiler's kernel intervals, so kernels
    that overlap count once), after one warm-up call; NaN where the profiler
    shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3 / reps if spans else float("nan")


def run(reps: int = 50, runs: int = 3, device="cuda"):
    """Time every entry at every case; returns ({case title: {entry: median
    ms}}, the same of device ms)."""
    out, dev = {}, {}
    for cases, split in ((WIDE, True), (NARROW, False)):
        for b, n, c in cases:
            for dtype in DTYPES:
                args = _inputs(b, n, c, dtype, device)
                entries = _entries(*args, split=split)
                title = f"({b},{n},{c}) h{H} dh{c // H} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                out[title] = {name: statistics.median(cuda_ms(fn, reps) for _ in range(runs))
                              for name, fn in entries.items()}
                dev[title] = {name: statistics.median(device_ms(fn, reps) for _ in range(runs))
                              for name, fn in entries.items()}
                del args, entries
                torch.cuda.empty_cache()
    return out, dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    out, dev = run(args.reps, args.runs)
    for title, results in out.items():
        report(title, {name: f"{ms:8.4f} ms, device {dev[title][name]:8.4f} ms" for name, ms in results.items()})
    flat = lambda table: {f"{name} {title}": ms for title, res in table.items() for name, ms in res.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": flat(out), "device_ms": flat(dev)}), flush=True)
    return out


if __name__ == "__main__":
    main()
