"""Injection-aware attention: FSAI and FGATS as a functional config over q/k/v.

Port of ``vface_tpu/ops/attention.py``: ``fuse_qkv`` in every mode (replace,
temporal, adain, mix, fft, flow_fix, fft_vfixed), with 2 or 3 chunks, the
bystander rows, the cross-window FGATS carry in (``prev_qk``/``flow0``)
and out, and the frame-sharded ``flow_axis`` form (frames sharded over ranks,
the blend's previous frame for a shard's first from the left neighbour).

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
    ``prev``: {site_name: {"q": (1, N, D), "k": (1, N, D)}}, the previous
    window's last frame's post-FSAI q/k per flow site (the cross-window carry),
    or None. ``flow0``: (1, Hq, Wq, 2) boundary flow mapping this window's
    frame-0 pixels back to the previous window's last frame, or None.
    ``pair_mask``: (F-1,) blend mask; 0 disables the blend at that pair (used
    to pack several independent windows into one batch).
    """

    flow: Optional[torch.Tensor] = None
    prev: Optional[dict] = None
    flow0: Optional[torch.Tensor] = None
    pair_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Static description of one attn1 injection site's fusion.

    mode: 'none' (vanilla self-attention), 'replace' (donor q/k into the other
    chunks), 'temporal' (a Gaussian frame window of the donor's q/k), 'adain'
    (channel AdaIN of donor and branch), 'mix' (a linear blend), 'fft' (FSAI:
    low-frequency channel bins from the branch, high from the donor),
    'flow_fix' (FSAI + the FGATS flow blend of the swap chunk's q/k where
    N == flow_tokens) or 'fft_vfixed' (FSAI, and each chunk's v pinned to its
    first frame's).
    """

    mode: str = "none"
    split_ratio: float = 0.8
    flow_alpha: float = 0.8
    mix_alpha: float = 0.5
    adain_alpha: float = 0.9
    temporal_window: int = 5
    temporal_sigma: float = 1.0
    flow_tokens: int = 4096
    use_circulant: bool = True
    # with 2 chunks the reference copies the donor into chunk 1; False applies
    # the fusion to chunk 1 instead (the recon-free sampler)
    two_chunk_replace: bool = True
    # trailing batch rows that neither give nor take fusion (a pipelined pack's
    # inversion rows riding the same UNet eval)
    bystander: int = 0
    # the frame-sharded FGATS form: the name of the mesh axis (parallel/mesh.py
    # resolves it to its group) that shards the frames; flow and pair_mask
    # then take the left-padded per-frame layout (f_local, Hq, Wq, 2) /
    # (f_local,), slot i = pair (prev, i), global frame 0's mask entry 0. No
    # cross-window carry in this form.
    flow_axis: Optional[str] = None

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
    prev_qk: Optional[dict] = None,
    flow0: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
):
    """Apply the configured cross-chunk fusion to projected q/k/v (B, N, D).

    B = chunks * F (+ ``cfg.bystander`` trailing rows, passed through). Returns
    (q, k, v, carry) in the input dtypes; the fusion math runs in float32, as
    the reference's ``.float()`` casts (JAX runs ``adain`` and ``mix`` in the
    input dtype; at bf16 torch's per-op rounding would differ from its anyway).
    ``carry`` is {"q", "k"} of the swap chunk's last frame after FSAI and
    before the blend (the cross-window FGATS carry) at flow sites, else None;
    ``prev_qk``/``flow0`` feed the previous window's carry into frame 0's blend.
    """
    if not cfg.active:
        return q, k, v, None
    if cfg.bystander:
        by = cfg.bystander
        inner = dataclasses.replace(cfg, bystander=0)
        q0, k0, v0, carry = fuse_qkv(q[:-by], k[:-by], v[:-by], inner, chunks=chunks, flow=flow,
                                     prev_qk=prev_qk, flow0=flow0, pair_mask=pair_mask)
        return (torch.cat([q0, q[-by:].to(q0.dtype)]), torch.cat([k0, k[-by:].to(k0.dtype)]),
                torch.cat([v0, v[-by:].to(v0.dtype)]), carry)
    carry = None
    b, n, d = q.shape
    f = b // chunks
    qc = q.reshape(chunks, f, n, d)
    kc = k.reshape(chunks, f, n, d)
    f32 = lambda x: x.to(torch.float32)

    def per_branch(op):
        """new chunk_i = op(donor=chunk0, branch=chunk_i) for i >= 1."""
        return (torch.stack([f32(qc[0])] + [op(qc[0], qc[i]) for i in range(1, chunks)]),
                torch.stack([f32(kc[0])] + [op(kc[0], kc[i]) for i in range(1, chunks)]))

    if cfg.mode == "replace":
        qn, kn = qc[:1].expand_as(qc), kc[:1].expand_as(kc)
    elif cfg.mode == "temporal":
        tq = Fu.temporal_gaussian(qc[0], cfg.temporal_window, cfg.temporal_sigma)
        tk = Fu.temporal_gaussian(kc[0], cfg.temporal_window, cfg.temporal_sigma)
        qn = torch.stack([f32(qc[0])] + [tq] * (chunks - 1))
        kn = torch.stack([f32(kc[0])] + [tk] * (chunks - 1))
    elif cfg.mode == "adain":
        qn, kn = per_branch(lambda d0, br: Fu.adain_fusion_attn(f32(d0), f32(br), alpha=cfg.adain_alpha))
    elif cfg.mode == "mix":
        qn, kn = per_branch(lambda d0, br: Fu.mix(f32(d0), f32(br), alpha=cfg.mix_alpha))
    elif cfg.mode in ("fft", "flow_fix", "fft_vfixed"):
        qn, kn = per_branch(lambda d0, br: _fft_combine(d0, br, cfg))
        if cfg.mode == "flow_fix" and flow is not None and n == cfg.flow_tokens:
            side = int(round(n**0.5))
            # FGATS on the swap chunk (index 1): one channel-concatenated warp of q and k
            q_sw = qn[1].reshape(f, side, side, d)
            k_sw = kn[1].reshape(f, side, side, d)
            if cfg.flow_axis is not None:
                # frame-sharded: the halo blend on the left-padded layout, no
                # carry; the 2-chunk donor copy below would discard the blend
                if chunks == 2 and cfg.two_chunk_replace:
                    raise ValueError("flow_axis (frame-sharded FGATS) requires the recon-free 2-chunk semantics "
                                     "(two_chunk_replace=False) or 3 chunks")
                qk = W.align_by_flow_halo(torch.cat([q_sw, k_sw], dim=-1), flow, cfg.flow_alpha, pair_mask,
                                          cfg.flow_axis)
                qn = torch.stack([qn[0], qk[..., :d].reshape(f, n, d), *qn[2:]])
                kn = torch.stack([kn[0], qk[..., d:].reshape(f, n, d), *kn[2:]])
                return qn.reshape(b, n, d).to(q.dtype), kn.reshape(b, n, d).to(k.dtype), v, None
            # the carry out: the last frame after FSAI, before the blend (the
            # blend warps the original previous frame, not its blended one)
            carry = {"q": q_sw[-1:].reshape(1, n, d), "k": k_sw[-1:].reshape(1, n, d)}
            prev0 = None
            if prev_qk is not None and flow0 is not None:
                prev0 = torch.cat([f32(prev_qk["q"]).reshape(1, side, side, d),
                                   f32(prev_qk["k"]).reshape(1, side, side, d)], dim=-1)
            qk = W.align_by_flow(torch.cat([q_sw, k_sw], dim=-1), flow, cfg.flow_alpha, prev0, flow0,
                                 pair_mask)
            qn = torch.stack([qn[0], qk[..., :d].reshape(f, n, d), *qn[2:]])
            kn = torch.stack([kn[0], qk[..., d:].reshape(f, n, d), *kn[2:]])
        if cfg.mode == "fft_vfixed":
            vc = v.reshape(chunks, f, n, d)
            v = torch.stack([vc[0]] + [vc[i][:1].expand_as(vc[i]) for i in range(1, chunks)]).reshape(b, n, d)
    else:
        raise ValueError(f"unknown fusion mode {cfg.mode!r}")

    if chunks == 2 and cfg.two_chunk_replace:
        # 2-chunk semantics: plain donor copy (the fused q/k are discarded)
        qn, kn = qc[:1].expand_as(qc), kc[:1].expand_as(kc)
        carry = None
    return qn.reshape(b, n, d).to(q.dtype), kn.reshape(b, n, d).to(k.dtype), v, carry


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, dtype=None,
    bias: torch.Tensor = None,
) -> torch.Tensor:
    """Softmax attention over (B, N, D), D = num_heads * d_head.

    Both products take the operands in ``dtype`` and accumulate in float32
    (written as float32 products of the rounded operands); the softmax runs in
    float32 and its probabilities are rounded to ``dtype`` before the P·V product.
    ``bias``: an additive float32 logit bias broadcastable to (B, H, Nq, Nk)
    (the CLIP text tower's causal and padding masks).
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
    if bias is not None:
        sim = sim + bias.to(torch.float32)
    attn = torch.softmax(sim, dim=-1).to(dtype).to(torch.float32)
    out = torch.matmul(attn, vh).to(dtype)
    return out.transpose(1, 2).reshape(b, nq, d)
