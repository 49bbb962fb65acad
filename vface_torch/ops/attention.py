"""Injection-aware attention: FSAI and FGATS as a functional config over q/k/v.

Port of ``vface_tpu/ops/attention.py`` for the modes on the swap path:
``fft`` (FSAI) and ``flow_fix`` (FSAI + FGATS), with 2 or 3 chunks. The other
modes (replace, temporal, adain, mix, fft_vfixed), the bystander rows and the
frame-sharded ``flow_axis`` form are not ported yet and raise.

Batch layout: frames are the batch dim; with guidance the leading axis is
``chunks * F`` in the order [uncond, cond(swap), recon]. The fusion donor is
chunk 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from vface_torch.ops import fusion as Fu
from vface_torch.ops import warp as W


class FlowPack(NamedTuple):
    """Flow payload threaded through the UNet's ``flow`` argument.

    ``flow``: (F-1, Hq, Wq, 2) within-window FGATS flow (or None).
    ``pair_mask``: (F-1,) blend mask; 0 disables the blend at that pair (used
    to pack several independent windows into one batch).
    """

    flow: Optional[torch.Tensor] = None
    pair_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Static description of one attn1 injection site's fusion.

    mode: 'none' (vanilla self-attention), 'fft' (FSAI: low-frequency channel
    bins from the branch, high from the donor) or 'flow_fix' (FSAI + FGATS
    flow blend of the swap chunk's q/k where N == flow_tokens).
    """

    mode: str = "none"
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    flow_tokens: int = 4096
    use_circulant: bool = True
    # with 2 chunks the reference copies the donor into chunk 1; False applies
    # the fusion to chunk 1 instead (the recon-free sampler)
    two_chunk_replace: bool = True

    @property
    def active(self) -> bool:
        return self.mode != "none"


def _fft_combine(donor, branch, cfg: FusionConfig):
    fn = Fu.combine_fft_high_low_circulant if cfg.use_circulant else Fu.combine_fft_high_low
    return fn(donor, branch, cfg.split_ratio)


def fuse_qkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: FusionConfig,
    chunks: int = 3,
    flow: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
):
    """Apply the configured cross-chunk fusion to projected q/k/v (B, N, D).

    B = chunks * F. Returns (q, k, v) in the input dtypes; the fusion math
    runs in float32.
    """
    if not cfg.active:
        return q, k, v
    if cfg.mode not in ("fft", "flow_fix"):
        raise ValueError(f"fusion mode {cfg.mode!r} is not ported")
    b, n, d = q.shape
    f = b // chunks
    qc = q.reshape(chunks, f, n, d)
    kc = k.reshape(chunks, f, n, d)
    if chunks == 2 and cfg.two_chunk_replace:
        # 2-chunk semantics: plain donor copy (the fused values are discarded)
        return (
            qc[:1].expand(chunks, f, n, d).reshape(b, n, d),
            kc[:1].expand(chunks, f, n, d).reshape(b, n, d),
            v,
        )
    qn = [qc[0].to(torch.float32)] + [_fft_combine(qc[0], qc[i], cfg) for i in range(1, chunks)]
    kn = [kc[0].to(torch.float32)] + [_fft_combine(kc[0], kc[i], cfg) for i in range(1, chunks)]
    if cfg.mode == "flow_fix" and flow is not None and n == cfg.flow_tokens:
        side = int(round(n**0.5))
        # FGATS on the swap chunk (index 1): one channel-concatenated warp of q and k
        qk = torch.cat(
            [qn[1].reshape(f, side, side, d), kn[1].reshape(f, side, side, d)], dim=-1
        )
        qk = W.align_by_flow(qk, flow, cfg.flow_alpha, pair_mask)
        qn[1] = qk[..., :d].reshape(f, n, d)
        kn[1] = qk[..., d:].reshape(f, n, d)
    q = torch.stack(qn).reshape(b, n, d).to(q.dtype)
    k = torch.stack(kn).reshape(b, n, d).to(k.dtype)
    return q, k, v


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, dtype=None
) -> torch.Tensor:
    """Softmax attention over (B, N, D), D = num_heads * d_head.

    Both products take the operands in ``dtype`` and accumulate in float32
    (written as float32 products of the rounded operands); the softmax runs in
    float32 and its probabilities are rounded to ``dtype`` before the P·V product.
    """
    dtype = dtype or q.dtype
    b, nq, d = q.shape
    nk = k.shape[1]
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    qh = q.reshape(b, nq, h, dh).transpose(1, 2).to(torch.float32)
    kh = k.reshape(b, nk, h, dh).transpose(1, 2).to(torch.float32)
    vh = v.reshape(b, nk, h, dh).transpose(1, 2).to(torch.float32)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1).to(dtype).to(torch.float32)
    out = torch.matmul(attn, vh).to(dtype)
    return out.transpose(1, 2).reshape(b, nq, d)
