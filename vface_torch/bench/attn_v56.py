"""K1 against K12 and SDPA at batch 24, on the card.

Port of ``scripts/bench_attn_v56.py``: h 8, dh 40, bf16, b 24 at N = 4096 and
N = 1024. JAX's ``flash_v5`` and ``flash_v6`` (each swept over ``block_q``)
map to K1 (``flash_attention``) and K12 (``flash_attention_v6``, K1's
kernel), ``xla_dpa`` to ``F.scaled_dot_product_attention``. K1 stages fixed
64-row tiles and takes no tile parameter, so each variant has one row.

Run: ``python -m vface_torch.bench.attn_v56 [--reps N]``
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from vface_torch.bench import cuda_ms, randn, report
from vface_torch.ops import _archive_attention as AA
from vface_torch.ops import flash_attention as FA

H, DH = 8, 40
CASES = ((24, 4096), (24, 1024))


def variants(b: int, n: int, h: int = H, dh: int = DH) -> dict:
    """Variant name -> fn(q, k, v)."""
    split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
    blk = min(1024, n)
    return {
        "xla_dpa (SDPA)": lambda q, k, v: F.scaled_dot_product_attention(split(q), split(k), split(v))
        .transpose(1, 2).reshape(b, n, h * dh),
        "flash_v5 (K1)": lambda q, k, v: FA.flash_attention(q, k, v, h),
        "flash_v6 (K12)": lambda q, k, v: AA.flash_attention_v6(q, k, v, h, block_q=blk, block_k=blk),
    }


def run(reps: int = 20, device="cuda") -> dict:
    """{case title: {variant: ms}}."""
    out = {}
    for b, n in CASES:
        q, k, v = (randn((b, n, H * DH), seed=s, device=device) for s in range(3))
        with torch.inference_mode():
            out[f"b={b} n={n} h={H} dh={DH} bf16"] = {
                name: cuda_ms(lambda: fn(q, k, v), reps) for name, fn in variants(b, n).items()}
        del q, k, v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0)}; K1 and K12: one row each, no tile parameter", flush=True)
    out = run(args.reps)
    for title, results in out.items():
        report(title, results)
    return out


if __name__ == "__main__":
    main()
