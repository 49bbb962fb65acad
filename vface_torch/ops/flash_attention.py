"""Flash attention, forward and backward: CUDA C++ for Hopper.

Kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_f32.cu``), each replacing a TPU kernel of
``vface_tpu/ops/pallas_attention.py``:

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
  and one over key tiles;
* K7 ``flash_attention_v2_stats`` (``_flash_v2_stats``): K6 that also writes
  m and l, the forward of ``flash_attention_v2``'s VJP (bf16: K6's kernel with
  K4's epilogue; fp32: K8's kernel with the same epilogue);
* K8 ``flash_attention_v1`` (``flash_attention`` / ``_flash_kernel``, the
  k-tiled v1): attention over (B, Nq, H*dh) x (B, Nk, H*dh), any input dtype
  cast to fp32, fp32 products on the CUDA cores, output in the input dtype.

K1 and K4-K6 are tensor-core bound at the UNet's shapes (ds1 N = 4096,
dh = 40; ds2 N = 1024, dh = 80): they keep S, P and dS on chip, run the
products with ``mma.sync`` and read the heads strided out of (B, N, H*dh)
without a split-heads copy. K8 is bound by the fp32 rate of the CUDA cores.
See the sources for the tiling.

:func:`flash_attention` is differentiable with the JAX package's VJP
(``_flash_v5_diff``): where a gradient is needed the forward is K4 and saves
q, k, v, m and l; the backward runs K6, D = rowsum(dO*O6) (a plain float32
reduction here, as in JAX), then K5. Where none is needed (inference mode,
``no_grad``, inputs that do not require grad) it is K1 and writes no
statistics; fp32 operands go to K8, which computes v5's function at fp32 (P
is not rounded when it already has the operands' type). K5 is bf16-only, so
on the card fp32 operands with a gradient raise.

:func:`flash_attention_v1` and :func:`flash_attention_v2` are the JAX
package's ``flash_attention`` and ``flash_attention_v2`` entry points with
their routing: a shape whose N the blocks do not divide goes to
:func:`multi_head_attention`, as in JAX. JAX's 8 MB VMEM guard in
``_flash_v2_impl`` (the v1 fallback at large N) is a TPU memory limit and is
not copied: K6 and K7 stream K/V tiles at any N.

Each wrapper launches its kernel for a CUDA tensor and calls its plain
version (``*_ref``) for a CPU tensor; on the card it raises for widths, dtypes
or gradients its kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad
from vface_torch.ops.attention import multi_head_attention

BLOCK_K = 64  # the kernels' K/V (and query) tile; the plain versions walk the same blocks
# head widths padded to the MMA k-step that the kernels are instantiated for:
# ds1's dh = 40 (as 48), ds2's dh = 80, and 16 for small test shapes
PADDED_DH = (16, 48, 80)
# K8's head widths: the JAX tests' 16, 32 and 40, and the UNet's 40 and 80
F32_DH = (16, 32, 40, 80)

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = dict.fromkeys(
    ("flash_attention", "flash_attention_stats", "flash_attention_fp32",
     "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_v2_stats",
     "flash_attention_v1"), 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 4 + [_I] * 4 + [_F, _P]
_STATS_ARGS = [_P] * 6 + [_I] * 4 + [_F, _P]
_DQ_ARGS = [_P] * 8 + [_I] * 4 + [_F, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 4 + [_F, _P]


# ------------------------------------------------------------ plain versions
def _online(q, k, v, num_heads: int, round_p: bool, block_k: int = BLOCK_K):
    """The kernels' blockwise online softmax over ``block_k``-key blocks;
    returns (out, m, l), m and l (B*H, Nq)."""
    b, n, d = q.shape
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    split = lambda t: t.reshape(b, -1, h, dh).transpose(1, 2).to(torch.float32)
    qh, kh, vh = split(q), split(k), split(v)
    m = torch.full((b, h, n, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, kh.shape[2], block_k):
        kb = kh[:, :, k0 : k0 + block_k]
        vb = vh[:, :, k0 : k0 + block_k]
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


def flash_attention_v1_ref(q, k, v, num_heads: int, block_k: int = 256) -> torch.Tensor:
    """Plain version of K8: fp32 scores and an online softmax over the JAX
    kernel's ``block_k``-key blocks, P in fp32, the output rounded once to q's dtype."""
    return _online(q, k, v, num_heads, round_p=False, block_k=min(block_k, k.shape[1]))[0]


def flash_attention_v2_stats_ref(q, k, v, num_heads: int, block_k: int = 1024):
    """Plain version of K7: K6's function over the JAX kernel's ``block_k``-key
    blocks, in fp32; returns (out, m, l), m and l (B*H, Nq) fp32."""
    return _online(q, k, v, num_heads, round_p=False, block_k=min(block_k, k.shape[1]))


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
    nk = k.shape[1]
    h = num_heads
    dh = d // h
    scale = dh**-0.5
    split = lambda t: t.reshape(b, -1, h, dh).transpose(1, 2).to(torch.float32)
    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    stat = lambda t: t.reshape(b, h, n, 1)
    m, l, dd = stat(m), stat(l), stat(dd)

    def probs(qb, kb, mb, lb):
        return torch.exp(torch.matmul(qb, kb.transpose(-1, -2)) * scale - mb) / lb

    rnd = (lambda x: x.to(q.dtype).to(torch.float32)) if round_p else (lambda x: x)

    dq = torch.zeros_like(qh)
    for k0 in range(0, nk, BLOCK_K):  # the dQ kernel: a loop over key blocks
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
    merge = lambda t: t.transpose(1, 2).reshape(b, -1, d).to(q.dtype)
    return merge(dq * scale), merge(dk * scale), merge(dv)


def flash_attention_ref(q, k, v, num_heads: int) -> torch.Tensor:
    """Plain version of K1; where a gradient is needed, of the whole op: its
    forward is K4's plain version and its backward K6's and K5's."""
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, num_heads, True, flash_attention_stats_ref)
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


def _launch_f32(kernel: str, stats: bool, q, k, v, num_heads: int, outs) -> None:
    """Launch K8's kernel (fp32 or bf16 operands; ``stats``: fp32 only, writing m and l)."""
    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // num_heads
    dt = q.dtype
    if dt not in ((torch.float32,) if stats else (torch.float32, torch.bfloat16)):
        raise ValueError(f"{kernel}: unsupported dtype {dt}")
    ops = {"q": (q, dt, (b, nq, d)), "k": (k, dt, (b, nk, d)), "v": (v, dt, (b, nk, d))}
    for i, t in enumerate(outs):
        ops[f"out{i}"] = (t, dt, (b, nq, d)) if i == 0 else (t, torch.float32, (b * num_heads, nq))
    _check(kernel, q, ops)
    if d % num_heads or dh not in F32_DH:
        raise ValueError(f"{kernel}: head width {d}/{num_heads} must be one of {F32_DH}")
    symbol = "vface_flash_attention_v1_" + ("stats_" if stats else "") + ("f32" if dt == torch.float32 else "bf16")
    fn = _native.function("flash_attention_f32", symbol, [_P] * (3 + len(outs)) + [_I] * 5 + [_F, _P])
    ptrs = [t.data_ptr() for t in (q, k, v, *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, float(dh**-0.5), stream), kernel)
    LAUNCHES[kernel] += 1


def _flash_attention_v1(q, k, v, num_heads: int, block_k: int = 256) -> torch.Tensor:
    """K8 on CUDA, its plain version on the CPU; no gradient."""
    if q.device.type == "cpu":
        return flash_attention_v1_ref(q, k, v, num_heads, block_k)
    out = torch.empty_like(q)
    _launch_f32("flash_attention_v1", False, q, k, v, num_heads, (out,))
    return out


def flash_attention_v2_stats(q, k, v, num_heads: int, block_k: int = 1024):
    """K7: (out, m, l); on CUDA K6's kernel with the stats epilogue for bf16
    (self-attention, Nq == Nk) or K8's for fp32, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_v2_stats_ref(q, k, v, num_heads, block_k)
    out = torch.empty_like(q)
    m, l = _stats(q.shape[0] * num_heads, q), _stats(q.shape[0] * num_heads, q)
    if q.dtype == torch.float32:
        _launch_f32("flash_attention_v2_stats", True, q, k, v, num_heads, (out, m, l))
    else:
        _launch("flash_attention_v2_stats", "vface_flash_attention_fp32p_stats_bf16", _STATS_ARGS, q, k, v,
                num_heads, {}, (out, m, l), "flash_attention_bwd")
    return out, m, l


class _FlashAttention(torch.autograd.Function):
    """The JAX package's VJP of ``flash_attention_v5`` and ``flash_attention_v2``
    (both ``_flash_v2_bwd``): the forward ``stats`` (K4 for v5, K7 for v2)
    saves q, k, v, m, l; the backward runs K6, D = rowsum(dO*O6), K5. ``plain``
    takes the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, plain: bool, stats):
        out, m, l = stats(q, k, v, num_heads)
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
        return (*bwd(q, k, v, do, m, l, dd, h), None, None, None)


def _refuse_grad_off_bf16(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cpu" and q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: a gradient through {q.dtype} operands needs K5, which takes bf16 only")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention over (B, N, H*dh), the port of ``flash_attention_v5``;
    differentiable (K4 forward, K6 + K5 backward, bf16) where a gradient is
    needed, K1 where none is (K8 for fp32 operands)."""
    if needs_grad(q, k, v):
        _refuse_grad_off_bf16("flash_attention", q)
        return _FlashAttention.apply(q, k, v, num_heads, False, flash_attention_stats)
    if q.dtype == torch.float32 and q.device.type != "cpu":
        return _flash_attention_v1(q, k, v, num_heads)
    return _flash_attention(q, k, v, num_heads)


def _tiles(q, k, block_q: int, block_k: int) -> bool:
    """JAX's ``_can_tile``: the blocks (capped at N) divide Nq and Nk."""
    nq, nk = q.shape[1], k.shape[1]
    return nq % min(block_q, nq) == 0 and nk % min(block_k, nk) == 0


def flash_attention_v1(q, k, v, num_heads: int, block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """The JAX package's ``flash_attention`` (v1, K8): (B, Nq, H*dh) queries over
    (B, Nk, H*dh) keys, computed in fp32, output in q's dtype. Shapes the blocks
    do not divide go to :func:`multi_head_attention`, as in JAX. JAX defines no
    VJP for it: on the card a call that needs a gradient raises."""
    if not _tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    if needs_grad(q, k, v) and q.device.type != "cpu":
        raise ValueError("flash_attention_v1: no gradient (the JAX package defines no VJP for it); "
                         "use flash_attention_v2")
    return _flash_attention_v1(q, k, v, num_heads, block_k)


def flash_attention_v2(q, k, v, num_heads: int, block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """The JAX package's ``flash_attention_v2``: attention with fp32 products and P
    (K6's function), output in q's dtype; differentiable with its VJP (K7
    forward saving m and l; K6 recompute, D, K5 backward; bf16 only on the
    card). Shapes the blocks do not divide go to :func:`multi_head_attention`."""
    if not _tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    if needs_grad(q, k, v):
        _refuse_grad_off_bf16("flash_attention_v2", q)
        stats = lambda *a: flash_attention_v2_stats(*a, block_k=block_k)
        return _FlashAttention.apply(q, k, v, num_heads, False, stats)
    if q.device.type == "cpu":
        return flash_attention_v2_stats_ref(q, k, v, num_heads, block_k)[0]
    if q.dtype == torch.float32:
        return _flash_attention_v1(q, k, v, num_heads)
    return flash_attention_fp32(q, k, v, num_heads)
