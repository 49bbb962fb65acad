"""Flash self-attention, forward and backward: CUDA C++ for Hopper.

Kernels (``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``),
each replacing a TPU kernel of ``vface_tpu/ops/pallas_attention.py``:

* K1 ``flash_attention`` (``flash_attention_v5`` / ``_flash_kernel_v5``):
  multi-head attention over (B, N, H*dh) bf16, fp32 scores times dh^-0.5, an
  online softmax with fp32 running max and sum, P rounded to bf16 before the
  P.V product, fp32 accumulation, bf16 output;
* K4 ``flash_attention_stats`` (``_flash_v5_stats``): K1 that also writes
  each row's final m and l, fp32 (B*H, N), for the backward;
* K6 ``flash_attention_fp32`` (``_flash_v2_impl``): the same attention with P
  kept at fp32 precision in P.V, which the backward uses to recompute O;
* K5 ``flash_attention_bwd`` (``flash_attention_bwd``): dQ, dK and dV from q,
  k, v, dO, m, l and D = rowsum(dO*O) in two kernels, one over query tiles
  and one over key tiles.

On the H100 all four are tensor-core bound at the UNet's shapes (ds1 N = 4096,
dh = 40; ds2 N = 1024, dh = 80): they keep S, P and dS on chip, run the
products on the tensor cores with ``mma.sync``, and read the heads strided out
of (B, N, H*dh) without a split-heads copy. See the sources for the tiling.

:func:`flash_attention` is differentiable with the JAX package's VJP
(``_flash_v5_diff``): where a gradient is needed the forward is K4 and saves
q, k, v, m and l; the backward runs K6, D = rowsum(dO*O6) (a plain float32
reduction here, as in JAX), then K5. Where none is needed (inference mode,
``no_grad``, inputs that do not require grad) it is K1 and writes no
statistics. Each wrapper launches its kernel for a CUDA tensor and calls its
plain version (``*_ref``) for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad

BLOCK_K = 64  # the kernels' K/V (and query) tile; the plain versions walk the same blocks
# head widths padded to the MMA k-step that the kernels are instantiated for:
# ds1's dh = 40 (as 48), ds2's dh = 80, and 16 for small test shapes
PADDED_DH = (16, 48, 80)

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = dict.fromkeys(
    ("flash_attention", "flash_attention_stats", "flash_attention_fp32",
     "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 4 + [_I] * 4 + [_F, _P]
_STATS_ARGS = [_P] * 6 + [_I] * 4 + [_F, _P]
_DQ_ARGS = [_P] * 8 + [_I] * 4 + [_F, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 4 + [_F, _P]


# ------------------------------------------------------------ plain versions
def _online(q, k, v, num_heads: int, round_p: bool):
    """The kernels' blockwise online softmax; returns (out, m, l), m and l (B*H, N)."""
    b, n, d = q.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    split = lambda t: t.reshape(b, -1, h, dh).transpose(1, 2).to(torch.float32)
    qh, kh, vh = split(q), split(k), split(v)
    m = torch.full((b, h, n, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, kh.shape[2], BLOCK_K):
        kb = kh[:, :, k0 : k0 + BLOCK_K]
        vb = vh[:, :, k0 : k0 + BLOCK_K]
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if round_p:
            p = p.to(q.dtype).to(torch.float32)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    out = (acc / l).to(q.dtype).transpose(1, 2).reshape(b, n, d)
    return out, m.reshape(b * h, n), l.reshape(b * h, n)


def flash_attention_stats_ref(q, k, v, num_heads: int):
    """Plain version of K4: K1's blockwise plain version, plus m and l (B*H, N) fp32.

    Walks the keys in ``BLOCK_K`` blocks with the kernel's online softmax, so
    that P is rounded to the input dtype relative to the running max exactly
    where the kernel (and ``_flash_kernel_v5``) rounds it.
    """
    return _online(q, k, v, num_heads, round_p=True)


def flash_attention_fp32_ref(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of K6: the same blocks with P not rounded; output in q's dtype."""
    return _online(q, k, v, num_heads, round_p=False)[0]


def flash_attention_bwd_ref(q, k, v, do, m, l, dd, num_heads: int, round_p: bool = False):
    """Plain version of K5's two kernels, blockwise, in float32: (dq, dk, dv) in q's dtype.

    ``m``, ``l``: the forward's row statistics; ``dd``: rowsum(dO*O) per head
    and row; all (B*H, N). P = exp(s*scale - m)/l and dS = P*(dP - D);
    dq = scale*dS.K over key blocks, dk = scale*dS^T.Q and dv = P^T.dO over
    query blocks. ``round_p`` rounds P and dS to q's dtype before their
    products, as FlashAttention-2 does and K5 does not: the error that keeping
    them at fp32 precision avoids, against which the card checks hold K5.
    """
    b, n, d = q.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    split = lambda t: t.reshape(b, n, h, dh).transpose(1, 2).to(torch.float32)
    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    stat = lambda t: t.reshape(b, h, n, 1)
    m, l, dd = stat(m), stat(l), stat(dd)

    def probs(qb, kb, mb, lb):
        return torch.exp(torch.matmul(qb, kb.transpose(-1, -2)) * scale - mb) / lb

    rnd = (lambda x: x.to(q.dtype).to(torch.float32)) if round_p else (lambda x: x)

    dq = torch.zeros_like(qh)
    for k0 in range(0, n, BLOCK_K):  # the dQ kernel: a loop over key blocks
        kb, vb = kh[:, :, k0 : k0 + BLOCK_K], vh[:, :, k0 : k0 + BLOCK_K]
        p = probs(qh, kb, m, l)
        ds = p * (torch.matmul(doh, vb.transpose(-1, -2)) - dd)
        dq = dq + torch.matmul(rnd(ds), kb)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, n, BLOCK_K):  # the dK/dV kernel: a loop over query blocks
        sl = slice(q0, q0 + BLOCK_K)
        qb, dob = qh[:, :, sl], doh[:, :, sl]
        p = probs(qb, kh, m[:, :, sl], l[:, :, sl])
        ds = p * (torch.matmul(dob, vh.transpose(-1, -2)) - dd[:, :, sl])
        dv = dv + torch.matmul(rnd(p).transpose(-1, -2), dob)
        dk = dk + torch.matmul(rnd(ds).transpose(-1, -2), qb)
    merge = lambda t: t.transpose(1, 2).reshape(b, n, d).to(q.dtype)
    return merge(dq * scale), merge(dk * scale), merge(dv)


def flash_attention_ref(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of K1; where a gradient is needed, of the whole op: its
    forward is K4's plain version and its backward K6's and K5's."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, num_heads, True)
    return _online(q, k, v, num_heads, round_p=True)[0]


def rowsum_do_o(do: torch.Tensor, o: torch.Tensor, num_heads: int) -> torch.Tensor:
    """D = rowsum(dO*O) per head and row, float32 (B*H, N) (``flash_attention_bwd`` :468)."""
    b, n, d = do.shape
    prod = do.to(torch.float32) * o.to(torch.float32)
    dd = prod.reshape(b, n, num_heads, d // num_heads).sum(dim=-1).transpose(1, 2)
    return dd.reshape(b * num_heads, n).contiguous()


# ------------------------------------------------------------------ wrappers
def _check(name: str, q: torch.Tensor, tensors: dict) -> None:
    """Validate a CUDA launch's operands: {arg: (tensor, dtype, shape)}."""
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    for arg, (t, dtype, shape) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be {dtype} {shape} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")


def _launch(kernel: str, symbol: str, argtypes, q, k, v, num_heads: int, extra: dict, outs, lib):
    b, n, d = q.shape
    dh = d // num_heads
    bf = torch.bfloat16
    ops = {"q": (q, bf, (b, n, d)), "k": (k, bf, (b, n, d)), "v": (v, bf, (b, n, d))}
    stat = (b * num_heads, n)
    for arg, t in extra.items():
        ops[arg] = (t, bf, (b, n, d)) if t.dtype == bf else (t, torch.float32, stat)
    _check(kernel, q, ops)
    if d % num_heads or dh % 8 or -(-dh // 16) * 16 not in PADDED_DH:
        raise ValueError(f"{kernel}: head width {d}/{num_heads} must be a multiple of 8 "
                         f"that pads to one of {PADDED_DH}")
    fn = _native.function(lib, symbol, argtypes)
    ptrs = [t.data_ptr() for t in (q, k, v, *extra.values(), *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _native.check(fn(*ptrs, b, n, num_heads, dh, float(dh**-0.5), stream), kernel)
    LAUNCHES[kernel] += 1


def _stats(n_rows: int, q: torch.Tensor):
    return torch.empty((n_rows, q.shape[1]), dtype=torch.float32, device=q.device)


def _flash_attention(q, k, v, num_heads: int) -> torch.Tensor:
    """K1, or its plain version for a CPU tensor; no gradient."""
    if q.device.type == "cpu":
        return _online(q, k, v, num_heads, round_p=True)[0]
    out = torch.empty_like(q)
    _launch("flash_attention", "vface_flash_attention_bf16", _FWD_ARGS, q, k, v, num_heads, {}, (out,),
            "flash_attention")
    return out


def flash_attention_stats(q, k, v, num_heads: int):
    """K4: (out, m, l); the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_stats_ref(q, k, v, num_heads)
    out = torch.empty_like(q)
    m, l = _stats(q.shape[0] * num_heads, q), _stats(q.shape[0] * num_heads, q)
    _launch("flash_attention_stats", "vface_flash_attention_stats_bf16", _STATS_ARGS, q, k, v, num_heads, {},
            (out, m, l), "flash_attention")
    return out, m, l


def flash_attention_fp32(q, k, v, num_heads: int) -> torch.Tensor:
    """K6; the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fp32_ref(q, k, v, num_heads)
    out = torch.empty_like(q)
    _launch("flash_attention_fp32", "vface_flash_attention_fp32p_bf16", _FWD_ARGS, q, k, v, num_heads, {},
            (out,), "flash_attention_bwd")
    return out


def flash_attention_bwd(q, k, v, do, m, l, dd, num_heads: int):
    """K5: (dq, dk, dv), two kernel launches on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, m, l, dd, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    extra = {"do": do, "m": m, "l": l, "dd": dd}
    _launch("flash_attention_bwd_dq", "vface_flash_attention_bwd_dq_bf16", _DQ_ARGS, q, k, v, num_heads, extra,
            (dq,), "flash_attention_bwd")
    _launch("flash_attention_bwd_dkv", "vface_flash_attention_bwd_dkv_bf16", _DKV_ARGS, q, k, v, num_heads,
            extra, (dk, dv), "flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's VJP of ``flash_attention_v5``: forward K4 (saving q, k,
    v, m, l); backward K6, D = rowsum(dO*O6), K5. ``plain`` takes the plain
    versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, plain: bool):
        out, m, l = (flash_attention_stats_ref if plain else flash_attention_stats)(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, m, l)
        ctx.num_heads, ctx.plain = num_heads, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, m, l = ctx.saved_tensors
        h = ctx.num_heads
        do = do.to(q.dtype).contiguous()
        fp32, bwd = ((flash_attention_fp32_ref, flash_attention_bwd_ref) if ctx.plain
                     else (flash_attention_fp32, flash_attention_bwd))
        dd = rowsum_do_o(do, fp32(q, k, v, h), h)
        return (*bwd(q, k, v, do, m, l, dd, h), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention over (B, N, H*dh); differentiable (K4 forward, K6 + K5
    backward) where a gradient is needed, K1 where none is."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, num_heads, False)
    return _flash_attention(q, k, v, num_heads)
