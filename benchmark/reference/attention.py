"""The benchmark reference's self-attention fusion and attention, plain float32.

FSAI (frequency-split attention injection): on the [uncond, cond] batch every
chunk after the first takes, for its q and k, the low-frequency channel bins
(the FFT over the channels, bins below ``split_ratio`` of them) of its own
and the high-frequency bins of chunk 0's. FGATS (flow-guided attention
temporal smoothing): where a site has ``flow_tokens`` tokens and a flow is
given, the swap chunk's fused q and k are blended, frame by frame, with the
previous frame's warped along the flow. The definitions of
``vface_torch/ops/{attention,fusion}.py``'s ``flow_fix`` mode, written with
the FFT (the program multiplies by the equivalent circulant matrix); this
module imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import warp as W


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """One attn1 site class's fusion: ``mode`` "none" or "flow_fix"."""

    mode: str = "none"
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    flow_tokens: int = 4096

    @property
    def active(self) -> bool:
        return self.mode != "none"


def combine_fft_high_low(donor: torch.Tensor, branch: torch.Tensor, split_ratio: float) -> torch.Tensor:
    """Low-frequency bins [0, split) of ``branch``, high ones [split, D) of ``donor``."""
    d = donor.shape[-1]
    mask = (torch.arange(d, device=donor.device) < int(d * split_ratio)).to(torch.float32)
    fd = torch.fft.fft(donor.to(torch.float32), dim=-1)
    fb = torch.fft.fft(branch.to(torch.float32), dim=-1)
    return torch.fft.ifft(fb * mask + fd * (1.0 - mask), dim=-1).real


def fuse_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FusionConfig, chunks: int, flow=None):
    """FSAI and FGATS on projected q, k (B, N, D), B = chunks * F; v passes."""
    if not cfg.active:
        return q, k, v
    if cfg.mode != "flow_fix":
        raise ValueError(f"the reference has no fusion mode {cfg.mode!r}")
    b, n, d = q.shape
    f = b // chunks
    fused = []
    for x in (q, k):
        xc = x.reshape(chunks, f, n, d).to(torch.float32)
        fused.append(torch.stack([xc[0]] + [combine_fft_high_low(xc[0], xc[i], cfg.split_ratio)
                                            for i in range(1, chunks)]))
    qn, kn = fused
    if flow is not None and n == cfg.flow_tokens:
        side = int(round(n**0.5))
        qk = W.align_by_flow(torch.cat([qn[1].reshape(f, side, side, d), kn[1].reshape(f, side, side, d)], dim=-1),
                             flow, cfg.flow_alpha)
        qn = torch.stack([qn[0], qk[..., :d].reshape(f, n, d), *qn[2:]])
        kn = torch.stack([kn[0], qk[..., d:].reshape(f, n, d), *kn[2:]])
    return qn.reshape(b, n, d).to(q.dtype), kn.reshape(b, n, d).to(k.dtype), v


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                         block_bytes: int = 1 << 30) -> torch.Tensor:
    """Softmax attention over (B, N, D), D = num_heads * d_head, in float32; the
    queries go in blocks whose score matrix stays under ``block_bytes``, so
    that 16,384 tokens fit."""
    b, nq, d = q.shape
    nk = k.shape[1]
    h = num_heads
    dh = d // h
    qh = q.reshape(b, nq, h, dh).transpose(1, 2).to(torch.float32)
    kh = k.reshape(b, nk, h, dh).transpose(1, 2).to(torch.float32)
    vh = v.reshape(b, nk, h, dh).transpose(1, 2).to(torch.float32)
    step = max(1, block_bytes // (4 * b * h * nk))
    outs = []
    for s0 in range(0, nq, step):
        sim = torch.matmul(qh[:, :, s0:s0 + step], kh.transpose(-1, -2)) * dh**-0.5
        outs.append(torch.matmul(torch.softmax(sim, dim=-1), vh))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, nq, d)
