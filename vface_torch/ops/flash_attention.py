"""Flash attention, forward and backward: CUDA C++ for Hopper.

Kernels (``csrc/flash_attention.cu``: K1, K4, K6, and K7 and K8 at bf16;
``csrc/flash_attention_bwd.cu``: K5; ``csrc/flash_attention_f32.cu``: K8, and
K4, K6 and K7 at fp32; ``csrc/flash_attention_bwd_f32.cu``: K5 at fp32), each
replacing a TPU kernel of ``vface_tpu/ops/pallas_attention.py``:

* K1 ``flash_attention`` (``flash_attention_v5`` / ``_flash_kernel_v5``):
  multi-head attention of (B, Nq, H*dh) bf16 queries over (B, Nk, H*dh) keys
  and values, fp32 scores times dh^-0.5, an online softmax with fp32 running
  max and sum, P rounded to bf16 before the P.V product, fp32 accumulation,
  bf16 output;
* K4 ``flash_attention_stats`` (``_flash_v5_stats``): K1 that also writes
  each row's final m and l, fp32 (B*H, Nq), for the backward;
* K6 ``flash_attention_fp32`` (``_flash_v2_impl``): the same attention with P
  kept at fp32 precision in P.V (K1's kernel with P split into bf16 hi + lo),
  which the backward uses to recompute O;
* K5 ``flash_attention_bwd`` (``flash_attention_bwd``): dQ, dK and dV from
  (B, Nq, H*dh) q and dO, (B, Nk, H*dh) k and v, and m, l and D = rowsum(dO*O)
  (B*H, Nq) in two kernels, one over query tiles and one over key tiles; on
  fp32 operands the same two loops as 3xTF32 (every product three tf32
  ``wgmma`` terms of hi + lo splits, from a split pass that writes each
  operand's tf32 planes in the layouts its products contract over);
* K7 ``flash_attention_v2_stats`` (``_flash_v2_stats``): K6 that also writes
  m and l, the forward of ``flash_attention_v2``'s VJP (bf16: K6's kernel with
  K4's epilogue; fp32: the tf32 kernel with the same epilogue);
* K8 ``flash_attention_v1`` (``flash_attention`` / ``_flash_kernel``, the
  k-tiled v1): attention over (B, Nq, H*dh) x (B, Nk, H*dh), any input dtype
  cast to fp32, output in the input dtype. fp32 operands run on the tf32
  kernel: every product as three tf32 ``wgmma`` terms of hi + lo splits
  (3xTF32), fed by a TMA ring from a split pass that writes K's and V's hi
  and lo planes once per call. bf16 operands run on K6's kernel, which
  computes the same function (exact bf16 products, P as a bf16 hi + lo
  pair), except at dh 32, which K6's kernel is not built for: those are cast
  to fp32 for the tf32 kernel (bf16 values are exact in tf32) and its output
  is rounded once to bf16.

At the UNet's shapes (ds1 N = 4096, dh = 40; ds2 N = 1024, dh = 80; above
512^2 also ds4, N >= 576, dh = 160) K1,
K4, K6 and K5 are bound by the exponentials and the tensor cores together;
they run every product on ``wgmma`` with a TMA ring of streamed tiles, and
all take Nq != Nk. All keep S, P and dS on chip and read the heads strided
out of (B, N, H*dh) without a split-heads copy. K8 on fp32 operands is bound
by its three tf32 products, 165 TFLOP/s of fp32-accurate products against
the CUDA cores' 67. See the sources for the tiling.

:func:`flash_attention` is differentiable with the JAX package's VJP
(``_flash_v5_diff``): where a gradient is needed the forward is K4 and saves
q, k, v, m and l; the backward runs K6, D = rowsum(dO*O6) (a plain float32
reduction here, as in JAX), then K5. Where none is needed (inference mode,
``no_grad``, inputs that do not require grad) it is K1 and writes no
statistics; fp32 operands go to K8's tf32 kernel, which computes v5's
function at fp32 (P is not rounded when it already has the operands' type).
With a gradient, fp32 operands run every step on the tensor cores as 3xTF32:
the forward K4 and K6 on the tf32 kernel (its ``STATS`` form is K7's at fp32;
at fp32 K4's P rounding is a no-op), then K5's fp32 kernels. The fp32 forms
count under their own ``LAUNCHES`` keys (``*_f32``).

:func:`flash_attention_v1` and :func:`flash_attention_v2` are the JAX
package's ``flash_attention`` and ``flash_attention_v2`` entry points with
their routing: a shape whose N the blocks do not divide goes to
:func:`multi_head_attention`, as in JAX. JAX's 8 MB VMEM guard in
``_flash_v2_impl`` (the v1 fallback at large N) is a TPU memory limit and is
not copied: K6 and K7 stream K/V tiles at any N.

Each wrapper launches its kernel for a CUDA tensor and calls its plain
version (``*_ref``) for a CPU tensor; on the card it raises for widths, dtypes
or gradients its kernel does not take (bf16 kernels: dh padding to 16, 48, 80
or 160; fp32: dh 16, 32, 40, 80, 160).
"""

from __future__ import annotations

import collections
import collections.abc
import ctypes
import functools

import torch

from vface_torch.ops import _native
from vface_torch.ops._autograd import needs_grad
from vface_torch.ops.attention import multi_head_attention

BLOCK_K = 64  # the kernels' K/V (and query) tile; the plain versions walk the same blocks
# head widths padded to the MMA k-step that the kernels are instantiated for:
# ds1's dh = 40 (as 48), ds2's dh = 80, ds4's dh = 160 (its self-attention
# takes the kernels above 512^2, at N >= 576), and 16 for small test shapes
PADDED_DH = (16, 48, 80, 160)
# the tf32 kernel's head widths: the JAX tests' 16, 32 and 40, and the UNet's
# 40, 80 and 160; K8 on bf16 operands casts them to fp32 for it at 32, the one
# of these that K6's kernel is not built for
F32_DH = (16, 32, 40, 80, 160)

# the kernels whose launches are counted
KERNELS = ("flash_attention", "flash_attention_stats", "flash_attention_fp32",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_v2_stats",
           "flash_attention_v1", "flash_attention_v3", "flash_attention_v4", "flash_attention_v6",
           "flash_attention_stats_f32", "flash_attention_fp32_f32", "flash_attention_bwd_dq_f32",
           "flash_attention_bwd_dkv_f32")
# kernel launches by (kernel, head width) since the last reset (read and
# cleared by chip_smoke.py): the one count the wrappers keep
DH_LAUNCHES = collections.Counter()


class _Launches(collections.abc.Mapping):
    """Launches by kernel name, summed over :data:`DH_LAUNCHES`'s head widths."""

    def __getitem__(self, kernel: str) -> int:
        if kernel not in KERNELS:
            raise KeyError(kernel)
        return sum(n for (name, _), n in DH_LAUNCHES.items() if name == kernel)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)


LAUNCHES = _Launches()


def _count(kernel: str, dh: int) -> None:
    DH_LAUNCHES[(kernel, dh)] += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 4 + [_I] * 5 + [_F, _I, _P]
_FWD_STATS_ARGS = [_P] * 6 + [_I] * 5 + [_F, _I, _P]
_DQ_ARGS = [_P] * 8 + [_I] * 5 + [_F, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 5 + [_F, _P]
_SPLIT_F32_ARGS = [_P] * 5 + [_I] * 5 + [_P]
_DQ_F32_ARGS = [_P] * 5 + [_I] * 5 + [_F, _P]
_DKV_F32_ARGS = [_P] * 6 + [_I] * 5 + [_F, _P]
CONSUMERS = (2, 3)  # the forward kernel's consumer warpgroups per CTA: 128 or 192 query rows


def built_consumers(split: bool, dh: int) -> tuple:
    """The forward kernel's query tiles built for head width ``dh``: both, but
    only 128 rows for K6 and K7 (``split``) at dh 80, which spill at 192, and
    for every form at dh 160 (a producer warpgroup and two consumers)."""
    dhp = -(-dh // 16) * 16
    return (2,) if dhp == 160 or (split and dhp == 80) else CONSUMERS


def k1_consumers(rows: int, nq: int, device: torch.device, split: bool, dh: int) -> int:
    """The forward kernel's consumer warpgroups per CTA (K1, K4, K6, K7 with
    ``split``) for ``rows`` = B*H heads of ``nq`` queries of width ``dh`` on a
    CUDA device, among :func:`built_consumers`: 3 (192 query rows,
    a third less K/V traffic than 128) unless 192-row tiles give fewer than
    two CTAs per SM, then 2 (PERF.md, K4: the card's times of both tiles at
    every batch of the main paths)."""
    tiles = built_consumers(split, dh)
    return 3 if 3 in tiles and -(-nq // 192) * rows >= 2 * _sm_count(torch.device(device)) else 2


def f32_cluster(rows: int, nq: int, dh: int, device: torch.device) -> bool:
    """Whether the tf32 kernel runs ``rows`` = B*H heads of ``nq`` queries at
    head width ``dh`` on clusters of two CTAs, each over half of dh's columns,
    which exchange their partial S: at dh 160 where the clusters' grid (two
    CTAs per 128 query rows) fits in one wave of the card's SMs. Where it does
    not, the SMs are full either way and one CTA per 128 rows over all of dh
    is faster (PERF.md §6, PR 19: at (1, 1024, 1280) the clusters take 0.136
    ms against 0.193, at (12, 576, 1280) 0.534 against 0.487)."""
    return dh == 160 and 2 * -(-nq // 128) * rows <= _sm_count(torch.device(device))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The device's SM count, read once: the query happens on every launch of a host-bound path."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _pads(d: int, num_heads: int) -> bool:
    """Whether the bf16 kernels are built for head width d / num_heads."""
    dh = d // num_heads
    return d % num_heads == 0 and dh % 8 == 0 and -(-dh // 16) * 16 in PADDED_DH


def _check_width(kernel: str, d: int, num_heads: int) -> None:
    if not _pads(d, num_heads):
        raise ValueError(f"{kernel}: head width {d}/{num_heads} must be a multiple of 8 "
                         f"that pads to one of {PADDED_DH}")


def _launch_bwd(kernel: str, symbol: str, argtypes, q, k, v, do, num_heads: int, stats, outs) -> None:
    """Launch one of K5's kernels (``csrc/flash_attention_bwd.cu``) on (B, Nq, D)
    queries and dO over (B, Nk, D) keys and values; ``stats`` = (m, l, dd),
    each (B*H, Nq) fp32; ``outs`` = (dq,) or (dk, dv)."""
    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // num_heads
    bf = torch.bfloat16
    ops = {"q": (q, bf, (b, nq, d)), "k": (k, bf, (b, nk, d)), "v": (v, bf, (b, nk, d)), "do": (do, bf, (b, nq, d))}
    for arg, t in zip(("m", "l", "dd"), stats):
        ops[arg] = (t, torch.float32, (b * num_heads, nq))
    for i, t in enumerate(outs):
        ops[f"out{i}"] = (t, bf, (b, nq if len(outs) == 1 else nk, d))
    _check(kernel, q, ops)
    _check_width(kernel, d, num_heads)
    fn = _native.function("flash_attention_bwd", symbol, argtypes)
    ptrs = [t.data_ptr() for t in (q, k, v, do, *stats, *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, float(dh**-0.5), stream), kernel)
    _count(kernel, dh)


def _launch_fwd(kernel: str, q, k, v, num_heads: int, outs, split: bool = False, consumers: int | None = None) -> None:
    """Launch the forward kernel on (B, Nq, D) queries over (B, Nk, D) keys and
    values: ``outs`` = (out,), or (out, m, l) for its STATS instantiations;
    ``split`` keeps P at fp32 precision (K6, K7). ``consumers`` (2 or 3) fixes
    the query tile, else :func:`k1_consumers` picks it."""
    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // num_heads
    bf = torch.bfloat16
    ops = {"q": (q, bf, (b, nq, d)), "k": (k, bf, (b, nk, d)), "v": (v, bf, (b, nk, d)),
           "out": (outs[0], bf, (b, nq, d))}
    for arg, t in zip("ml", outs[1:]):
        ops[arg] = (t, torch.float32, (b * num_heads, nq))
    _check(kernel, q, ops)
    _check_width(kernel, d, num_heads)
    if consumers is None:
        consumers = k1_consumers(b * num_heads, nq, q.device, split, dh)
    elif consumers not in built_consumers(split, dh):
        raise ValueError(f"{kernel}: consumers must be one of {built_consumers(split, dh)}")
    stats = len(outs) == 3
    symbol = "vface_flash_attention_" + ("fp32p_" if split else "") + ("stats_" if stats else "") + "bf16"
    fn = _native.function("flash_attention", symbol, _FWD_STATS_ARGS if stats else _FWD_ARGS)
    ptrs = [t.data_ptr() for t in (q, k, v, *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, float(dh**-0.5), consumers, stream), kernel)
    _count(kernel, dh)


def _stats(n_rows: int, q: torch.Tensor):
    return torch.empty((n_rows, q.shape[1]), dtype=torch.float32, device=q.device)


def _flash_attention(q, k, v, num_heads: int) -> torch.Tensor:
    """K1, or its plain version for a CPU tensor; no gradient."""
    if q.device.type == "cpu":
        return _online(q, k, v, num_heads, round_p=True)[0]
    out = torch.empty_like(q)
    _launch_fwd("flash_attention", q, k, v, num_heads, (out,))
    return out


def flash_attention_stats(q, k, v, num_heads: int):
    """K4: (out, m, l); the kernel on CUDA (bf16; fp32 on the tf32 kernel's
    STATS form, K7's at fp32), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_stats_ref(q, k, v, num_heads)
    out = torch.empty_like(q)
    m, l = _stats(q.shape[0] * num_heads, q), _stats(q.shape[0] * num_heads, q)
    if q.dtype == torch.float32:
        _launch_f32("flash_attention_stats_f32", True, q, k, v, num_heads, (out, m, l))
    else:
        _launch_fwd("flash_attention_stats", q, k, v, num_heads, (out, m, l))
    return out, m, l


def flash_attention_fp32(q, k, v, num_heads: int) -> torch.Tensor:
    """K6: (B, Nq, D) over (B, Nk, D); the kernel on CUDA (bf16; fp32 on the
    tf32 kernel, which computes K6's function at fp32), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fp32_ref(q, k, v, num_heads)
    out = torch.empty_like(q)
    if q.dtype == torch.float32:
        _launch_f32("flash_attention_fp32_f32", False, q, k, v, num_heads, (out,))
    else:
        _launch_fwd("flash_attention_fp32", q, k, v, num_heads, (out,), split=True)
    return out


def flash_attention_bwd(q, k, v, do, m, l, dd, num_heads: int):
    """K5: (dq, dk, dv) for (B, Nq, D) q and dO over (B, Nk, D) k and v, with m,
    l and dd (B*H, Nq); two kernel launches on CUDA (fp32: after the split
    pass), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, m, l, dd, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        planes = _bwd_f32_planes(q, k, v, do, num_heads)
        _launch_bwd_f32("flash_attention_bwd_dq_f32", planes, q, k, num_heads, (m, l, dd), (dq,))
        _launch_bwd_f32("flash_attention_bwd_dkv_f32", planes, q, k, num_heads, (m, l, dd), (dk, dv))
        return dq, dk, dv
    _launch_bwd("flash_attention_bwd_dq", "vface_flash_attention_bwd_dq_bf16", _DQ_ARGS, q, k, v, do, num_heads,
                (m, l, dd), (dq,))
    _launch_bwd("flash_attention_bwd_dkv", "vface_flash_attention_bwd_dkv_bf16", _DKV_ARGS, q, k, v, do, num_heads,
                (m, l, dd), (dk, dv))
    return dq, dk, dv


def _check_f32_width(kernel: str, d: int, num_heads: int) -> int:
    dh = d // num_heads
    if d % num_heads or dh not in F32_DH:
        raise ValueError(f"{kernel}: head width {d}/{num_heads} must be one of {F32_DH}")
    return dh


def _bwd_f32_planes(q, k, v, do, num_heads: int) -> torch.Tensor:
    """K5 on fp32, its split pass (``csrc/flash_attention_bwd_f32.cu``): q, k,
    v and dO (fp32) as tf32 hi and lo planes, plain and transposed, per
    64-row block of each (batch, head), in a scratch tensor for the dQ and
    dK/dV kernels (:func:`_launch_bwd_f32`)."""
    b, nq, d = q.shape
    nk = k.shape[1]
    f32 = torch.float32
    _check("flash_attention_bwd_f32", q, {"q": (q, f32, (b, nq, d)), "k": (k, f32, (b, nk, d)),
                                          "v": (v, f32, (b, nk, d)), "do": (do, f32, (b, nq, d))})
    dh = _check_f32_width("flash_attention_bwd_f32", d, num_heads)
    blocks = 2 * -(-nq // 64) + 2 * -(-nk // 64)  # 64-row blocks of q and dO, k and v
    planes = torch.empty(4 * b * num_heads * dh * 64 * blocks, dtype=f32, device=q.device)
    fn = _native.function("flash_attention_bwd_f32", "vface_flash_attention_bwd_split_f32", _SPLIT_F32_ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, do, planes)]
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, stream), "flash_attention_bwd_f32 split")
    return planes


def _launch_bwd_f32(kernel: str, planes, q, k, num_heads: int, stats, outs) -> None:
    """Launch K5's fp32 dQ (``outs`` = (dq,)) or dK/dV kernel (``outs`` = (dk,
    dv)) on the planes of :func:`_bwd_f32_planes`; ``stats`` = (m, l, dd),
    each (B*H, Nq) fp32."""
    b, nq, d = q.shape
    nk = k.shape[1]
    f32 = torch.float32
    ops = {f"out{i}": (t, f32, (b, nq if len(outs) == 1 else nk, d)) for i, t in enumerate(outs)}
    ops.update({arg: (t, f32, (b * num_heads, nq)) for arg, t in zip(("m", "l", "dd"), stats)})
    _check(kernel, q, ops)
    dh = _check_f32_width(kernel, d, num_heads)
    dkv = len(outs) == 2
    symbol = "vface_flash_attention_bwd_" + ("dkv" if dkv else "dq") + "_f32"
    fn = _native.function("flash_attention_bwd_f32", symbol, _DKV_F32_ARGS if dkv else _DQ_F32_ARGS)
    ptrs = [t.data_ptr() for t in (planes, *stats, *outs)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, float(dh**-0.5), stream), kernel)
    _count(kernel, dh)


def _launch_f32(kernel: str, stats: bool, q, k, v, num_heads: int, outs) -> None:
    """Launch the tf32 kernel (``csrc/flash_attention_f32.cu``) on fp32 operands
    at ``F32_DH`` (``stats`` also writes m and l): its split pass writes each
    key tile's K and V^T tf32 hi and lo planes to a scratch tensor, then the
    attention kernel runs; one launch in ``LAUNCHES``."""
    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // num_heads
    f32 = torch.float32
    if q.dtype != f32:
        raise ValueError(f"{kernel}: unsupported dtype {q.dtype}")
    ops = {"q": (q, f32, (b, nq, d)), "k": (k, f32, (b, nk, d)), "v": (v, f32, (b, nk, d))}
    for i, t in enumerate(outs):
        ops[f"out{i}"] = (t, f32, (b, nq, d) if i == 0 else (b * num_heads, nq))
    _check(kernel, q, ops)
    _check_f32_width(kernel, d, num_heads)
    # the split pass's planes; freed when this returns, which is safe: the caching
    # allocator hands the memory only to work queued after the kernels on this stream
    kv = torch.empty(b * num_heads * -(-nk // BLOCK_K) * 4 * BLOCK_K * dh, dtype=torch.float32, device=q.device)
    symbol = "vface_flash_attention_v1_" + ("stats_" if stats else "") + "f32"
    fn = _native.function("flash_attention_f32", symbol, [_P] * (4 + len(outs)) + [_I] * 5 + [_F, _I, _P])
    ptrs = [t.data_ptr() for t in (q, k, v, *outs, kv)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cluster = f32_cluster(b * num_heads, nq, dh, q.device)
    _native.check(fn(*ptrs, b, nq, nk, num_heads, dh, float(dh**-0.5), int(cluster), stream), kernel)
    _count(kernel, dh)


def _launch_k8(kernel: str, q, k, v, num_heads: int, out) -> None:
    """K8's function on the card, counted under ``kernel``: fp32 operands on
    the tf32 kernel; bf16 ones on K6's kernel (``split``) where it is built for
    the width, else (dh 32) cast to fp32 for the tf32 kernel, whose output is
    rounded once to bf16."""
    if q.dtype != torch.bfloat16:
        _launch_f32(kernel, False, q, k, v, num_heads, (out,))
    elif _pads(q.shape[2], num_heads):
        _launch_fwd(kernel, q, k, v, num_heads, (out,), split=True)
    else:
        o32 = torch.empty(out.shape, dtype=torch.float32, device=out.device)
        _launch_f32(kernel, False, q.float(), k.float(), v.float(), num_heads, (o32,))
        out.copy_(o32)


def _flash_attention_v1(q, k, v, num_heads: int, block_k: int = 256) -> torch.Tensor:
    """K8 on CUDA, its plain version on the CPU; no gradient."""
    if q.device.type == "cpu":
        return flash_attention_v1_ref(q, k, v, num_heads, block_k)
    out = torch.empty_like(q)
    _launch_k8("flash_attention_v1", q, k, v, num_heads, out)
    return out


def flash_attention_v2_stats(q, k, v, num_heads: int, block_k: int = 1024):
    """K7: (out, m, l); on CUDA K6's kernel with the stats epilogue for bf16 or
    the tf32 kernel's for fp32, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_v2_stats_ref(q, k, v, num_heads, block_k)
    out = torch.empty_like(q)
    m, l = _stats(q.shape[0] * num_heads, q), _stats(q.shape[0] * num_heads, q)
    if q.dtype == torch.float32:
        _launch_f32("flash_attention_v2_stats", True, q, k, v, num_heads, (out, m, l))
    else:
        _launch_fwd("flash_attention_v2_stats", q, k, v, num_heads, (out, m, l), split=True)
    return out, m, l


class _FlashAttention(torch.autograd.Function):
    """The JAX package's VJP of ``flash_attention_v5`` and ``flash_attention_v2``
    (both ``_flash_v2_bwd``): the forward ``stats`` (K4 for v5, K7 for v2)
    saves q, k, v, m, l; the backward runs K6, D = rowsum(dO*O6), K5 (each in
    its bf16 or fp32 form, by the operands' dtype). ``plain`` takes the plain
    versions on any device."""

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention of (B, Nq, H*dh) queries over (B, Nk, H*dh) keys and values, the
    port of ``flash_attention_v5``; differentiable (K4 forward, K6 + K5
    backward; bf16, or fp32 as 3xTF32) where a gradient is needed, K1 where
    none is (K8's tf32 kernel for fp32 operands)."""
    if needs_grad(q, k, v):
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
    forward saving m and l; K6 recompute, D, K5 backward; bf16, or fp32 as
    3xTF32). Shapes the blocks do not divide go to :func:`multi_head_attention`."""
    if not _tiles(q, k, block_q, block_k):
        return multi_head_attention(q, k, v, num_heads, dtype=q.dtype)
    if needs_grad(q, k, v):
        stats = lambda *a: flash_attention_v2_stats(*a, block_k=block_k)
        return _FlashAttention.apply(q, k, v, num_heads, False, stats)
    if q.device.type == "cpu":
        return flash_attention_v2_stats_ref(q, k, v, num_heads, block_k)[0]
    if q.dtype == torch.float32:
        return _flash_attention_v1(q, k, v, num_heads)
    return flash_attention_fp32(q, k, v, num_heads)
