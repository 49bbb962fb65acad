"""The tf32 forward attention kernel on fp32 operands, on the card.

``csrc/flash_attention_f32.cu`` serves four entry points on fp32 operands:
K8 (``flash_attention_v1``), and K4, K6 and K7 (``flash_attention_stats``,
``flash_attention_fp32``, ``flash_attention_v2_stats``: its ``STATS`` form
for K4 and K7). This times each at the UNet's ds1 (dh 40) and ds2 (dh 80)
self-attention shapes, h 8, at b = 1 (a train step's) and b = 12 (a 6-frame
window's CFG batch), and K8 at the 1024^2 ds1 site (N = 16384), each beside
SDPA on the same fp32 operands (the library's time). It has no
JAX counterpart: it compares two trees' kernels at widths both build, run
once under each tree's ``PYTHONPATH`` in one call.

Run: ``python -m vface_torch.bench.attn_f32 [--reps N]``; the last line is
one JSON object {"device": name, "ms": {"entry (b,n,c)": ms}}.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from vface_torch.bench import cuda_ms, randn, report
from vface_torch.ops import flash_attention as FA

H = 8
CASES = ((1, 4096, 320), (1, 16384, 320), (12, 1024, 320), (1, 1024, 640), (12, 1024, 640))


def sdpa(q, k, v, heads: int) -> torch.Tensor:
    """SDPA on the same (B, N, H*dh) operands: the library's time for the
    same function beside the kernels (the port never calls it)."""
    b, n, c = q.shape
    split = lambda t: t.view(b, -1, heads, c // heads).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v)).transpose(1, 2).reshape(b, n, c)


ENTRIES = {"K8 flash_attention_v1": FA.flash_attention_v1, "K4 flash_attention_stats": FA.flash_attention_stats,
           "K6 flash_attention_fp32": FA.flash_attention_fp32, "K7 flash_attention_v2_stats": FA.flash_attention_v2_stats,
           "SDPA": sdpa}


def run(reps: int = 20, device="cuda") -> dict:
    """Time every entry at every case (K8 alone at N = 16384); returns
    {case title: {entry: ms}}."""
    out = {}
    for b, n, c in CASES:
        q, k, v = (randn((b, n, c), seed=s, device=device, dtype=torch.float32) for s in range(3))
        entries = {name: fn for name, fn in ENTRIES.items() if n <= 4096 or name.startswith(("K8", "SDPA"))}
        with torch.inference_mode():
            out[f"({b},{n},{c}) h{H} dh{c // H} fp32"] = {
                name: cuda_ms(lambda: fn(q, k, v, H), reps) for name, fn in entries.items()}
        del q, k, v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    out = run(args.reps)
    for title, results in out.items():
        report(title, results)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": {f"{name} {title}": ms for title, res in out.items() for name, ms in res.items()}}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
