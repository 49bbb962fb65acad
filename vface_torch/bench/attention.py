"""Attention microbenchmark at the UNet's self-attention shapes, on the card.

Port of ``scripts/bench_attention.py``: h 8, dh 40, bf16, the 2-chunk
recon-free sampling batch of a 6-frame window (b = 12) at ds1 (N = 4096) and
ds2 (N = 1024); ``--packed`` adds the packed-window batches (b = 24 and 48).
Each JAX variant maps to its port counterpart:

  einsum   -> ``multi_head_attention`` (plain PyTorch)
  flash_v2 -> ``flash_attention_v2`` (K6, fp32 P)
  flash_v5 -> ``flash_attention`` (K1)
  flash_v3 -> ``flash_attention_v3`` (K10: K8's function, here on K6's kernel)
  flash_v4 -> ``flash_attention_v4`` (K11: likewise, K6's kernel)
  flash_v6 -> ``flash_attention_v6`` (K12, K1's kernel)
  xla_dpa  -> ``F.scaled_dot_product_attention``
  jax_fa, splash -> none: TPU library kernels

The JAX script sweeps the TPU kernels' ``block_q``/``block_k``; the port's
kernels stage fixed tiles (K1's kernel, K6's with it: 128 or 192 query rows
and 64-key tiles) and take no tile parameter, so each of those variants has
one row, at JAX's default blocks (which decide only the routing and the
plain versions' key blocks).

Run: ``python -m vface_torch.bench.attention [--packed] [--reps N]``
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from vface_torch.bench import cuda_ms, randn, report
from vface_torch.ops import _archive_attention as AA
from vface_torch.ops import flash_attention as FA
from vface_torch.ops.attention import multi_head_attention

H, DH = 8, 40
CASES = (("ds1 (64^2, 2-chunk w6)", 12, 4096), ("ds2 (32^2)", 12, 1024))
PACKED = (("ds1 packed bw=2", 24, 4096), ("ds1 packed bw=4", 48, 4096),
          ("ds2 packed bw=2", 24, 1024), ("ds2 packed bw=4", 48, 1024))
NO_TILE = "one row: the port kernel takes no tile parameter"


def variants(b: int, n: int, h: int = H, dh: int = DH) -> dict:
    """Variant name -> fn(q, k, v), or the reason it has no port counterpart."""
    split = lambda t: t.view(b, n, h, dh).transpose(1, 2)
    blk = min(1024, n)
    return {
        "einsum": lambda q, k, v: multi_head_attention(q, k, v, h, dtype=q.dtype),
        "flash_v2 (K6)": lambda q, k, v: FA.flash_attention_v2(q, k, v, h),
        "flash_v5 (K1)": lambda q, k, v: FA.flash_attention(q, k, v, h),
        "flash_v6 (K12)": lambda q, k, v: AA.flash_attention_v6(q, k, v, h, block_q=blk, block_k=blk),
        "flash_v3 (K10)": lambda q, k, v: AA.flash_attention_v3(q, k, v, h, block_q=blk, block_k=blk),
        "flash_v4 (K11)": lambda q, k, v: AA.flash_attention_v4(q, k, v, h, block_q=blk, block_k=blk),
        "jax_fa": "no counterpart: a TPU library kernel",
        "splash": "no counterpart: a TPU library kernel",
        "xla_dpa (SDPA)": lambda q, k, v: F.scaled_dot_product_attention(split(q), split(k), split(v))
        .transpose(1, 2).reshape(b, n, h * dh),
    }


def run(packed: bool = False, reps: int = 20, device="cuda") -> dict:
    """Time every variant at every case; returns {case title: {variant: ms or reason}}."""
    out = {}
    for title, b, n in CASES + (PACKED if packed else ()):
        q, k, v = (randn((b, n, H * DH), seed=s, device=device) for s in range(3))
        results = {}
        with torch.inference_mode():
            for name, fn in variants(b, n).items():
                if isinstance(fn, str):
                    results[name] = fn
                    continue
                try:
                    results[name] = cuda_ms(lambda: fn(q, k, v), reps)
                except torch.OutOfMemoryError:  # the einsum path at the largest packed batch
                    results[name] = "FAIL OutOfMemoryError"
                    torch.cuda.empty_cache()
        out[f"{title}: b={b} n={n} h={H} dh={DH} bf16"] = results
        del q, k, v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--packed", action="store_true", help="add the packed-window batches (b = 24, 48)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0)}; K1, K6, K8, K10-K12: {NO_TILE}", flush=True)
    out = run(args.packed, args.reps)
    for title, results in out.items():
        report(title, results)
    return out


if __name__ == "__main__":
    main()
