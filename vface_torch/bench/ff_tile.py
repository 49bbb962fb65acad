"""Row-tile sweep of the fused GEGLU kernel at the ds1/ds2 widths, on the card.

Port of ``scripts/bench_ff_tile.py``: C = 320 with M = 24*4096 and C = 640
with M = 24*1024, I = 4C, bf16, x ~ N(0, 0.1^2), weights ~ N(0, 0.02^2),
zero biases. The JAX script sweeps the row tile ``tm`` of ``_pallas_impl``
and of ``_pallas_split``, two kernels with the same body line for line; the
port has one kernel for both, K13 (``geglu_ff_split``, K2's kernel at the row
tiles in ``SPLIT_TILES``), swept here. JAX's ``xla`` row is the unfused route,
``geglu_ff_unfused`` (two cuBLAS bf16 products with fp32 accumulation).

Ends with one JSON line: ``{"c320_split16": ms, ..., "c320_xla": ms, ...}``.

Run: ``python -m vface_torch.bench.ff_tile [--reps N]``
"""

from __future__ import annotations

import argparse
import json

import torch

from vface_torch.bench import cuda_ms, randn
from vface_torch.ops import geglu_ff as FF

CASES = ((320, 24 * 4096), (640, 24 * 1024))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak


def operands(c: int, m: int, device="cuda") -> tuple:
    """x (M, C) and the weights in the port's Linear layout, seeded."""
    inner = 4 * c
    return (randn((m, c), 0, device, scale=0.1), randn((2 * inner, c), 1, device, scale=0.02),
            torch.zeros(2 * inner, dtype=torch.bfloat16, device=device),
            randn((c, inner), 2, device, scale=0.02), torch.zeros(c, dtype=torch.bfloat16, device=device))


def run(reps: int = 20, device="cuda") -> dict:
    """{"c{C}_split{tm}": ms for each built tile, "c{C}_xla": ms}."""
    results = {}
    for c, m in CASES:
        args = operands(c, m, device)
        flops = m * 2 * (c * 2 * 4 * c + 4 * c * c)
        print(f"== C={c} M={m}  floor {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms ==", flush=True)
        with torch.inference_mode():
            for tm in FF.SPLIT_TILES[c]:
                t = cuda_ms(lambda: FF.geglu_ff_split(*args, tm), reps)
                results[f"c{c}_split{tm}"] = round(t, 4)
                print(f"  split tm={tm:<5d} {t:8.3f} ms", flush=True)
            t = cuda_ms(lambda: FF.geglu_ff_unfused(*args), reps)
        results[f"c{c}_xla"] = round(t, 4)
        print(f"  xla (unfused) {t:8.3f} ms", flush=True)
        del args
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    results = run(args.reps)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
