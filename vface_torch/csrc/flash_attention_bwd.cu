// Flash attention backward for Hopper (sm_90a), bf16: K5.
//
// Replaces vface_tpu/ops/pallas_attention.py::flash_attention_bwd and its two
// kernels: _flash_bwd_dq_kernel (dQ; grid over query tiles, a loop over keys)
// and _flash_bwd_dkv_kernel (dK and dV; grid over key tiles, a loop over
// queries). Both recompute P = exp(s * scale - m) / l from the forward's row
// statistics (m in the units K4 writes it in: the max of the scaled scores)
// and dS = P * (dP - D) with dP = dO . V^T and D = rowsum(dO * O);
// dQ = scale * dS . K, dK = scale * dS^T . Q, dV = P^T . dO, each rounded once
// to bf16. P and dS never touch device memory. Queries (B, Nq, H*dh) and
// keys (B, Nk, H*dh) may differ in length; m, l and D are (B*H, Nq). The two
// kernels keep the JAX function's form: each output is summed in a fixed
// order by one CTA, so the result is the same from launch to launch (a fused
// kernel with fp32 atomics for dQ would not be).
//
// Precision. q, k, v and dO are bf16 values, so S = Q K^T and dP = dO V^T are
// exact products with fp32 sums. P and dS are fp32 values and are NOT rounded
// to bf16 alone (FlashAttention-2 does; the TPU kernels do not): each is split
// in registers into x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), and
// its product with the bf16 operand runs as two wgmma groups into one fp32
// accumulator. The pair carries ~16 significant bits, so each product term is
// good to ~2^-17 relative, far below the one bf16 rounding of the result.
//
// What bounds it on the H100 at the UNet's training sites (ds1 N = 4096,
// dh = 40 padded to 48; ds2 N = 1024, dh = 80): ten N^2-products at dh 48
// (S and dP in both kernels, and dQ, dK, dV as hi + lo pairs) on the tensor
// cores, ~0.13 ms at ds1, and 2 N^2 exponentials on the SFUs, ~0.06 ms; in
// practice, as in K1, the latency of each warpgroup's chain S, dP -> P,
// dS -> the products.
//
// The design, K1's (flash_attention.cu):
// * One CTA owns 128 rows of one (batch, head): two consumer warpgroups of 64
//   rows share each streamed tile. The dQ kernel holds its Q and dO rows
//   resident and streams 64-key K and V tiles; the dK/dV kernel holds its K
//   and V rows and streams 64-query Q and dO tiles. One warp of a producer
//   warpgroup keeps a ring of 4 stages filled by TMA, completed on mbarriers
//   (full: the bytes landed and, for dK/dV, the stage's statistics are
//   written; empty: every consumer warp is done with the stage). The
//   producer warpgroup hands its registers to the consumers (setmaxnreg,
//   24 / 240): a consumer of the dK/dV kernel holds two accumulators, S^T and
//   dP^T, and the hi and lo fragments of P^T and dS^T, which spilled at the
//   168 registers a thread that a producer warp leaves (ptxas), and at dh 48
//   left ptxas too few to keep the wgmma pipeline (C7511).
// * Every product runs on wgmma with fp32 accumulators. The products that
//   contract over dh (S, dP, S^T, dP^T) read both operands from shared memory
//   K-major; the ones that contract over the tile's rows (dS.K, P^T.dO,
//   dS^T.Q) take the split fp32 values as the register operand and read the
//   streamed [row][dh] tile through wgmma's transposed-B (MN-major) mode, as
//   K1 reads V: no operand is transposed through shared memory.
// * The dK/dV kernel needs the statistics of its streamed queries by
//   column of S^T, not by row: the producer warp writes each stage's
//   lse = m * log2(e) + log2(l) and D for the tile's 64 queries into shared
//   memory beside its Q and dO (+inf and 0 past Nq, so P = 0 there), and
//   each thread reads its accumulator columns' values from there. P is then
//   one FFMA and one ex2 a score: ex2(s * scale * log2(e) - lse). The dQ
//   kernel's threads hold their two rows' lse and D in registers.
// * Groups are issued as in K1's loop, so that a warpgroup's softmax work
//   overlaps its own tensor work: tile j's S and dP and the products of tile
//   j-1 go out together as three groups; P(j) is computed while dP(j) runs,
//   dS(j) while the products run, and their hi and lo fragments are packed
//   once the products are done (dQ; dK/dV at dh <= 48: at dh 80 its
//   registers do not hold both tiles' fragments, and tile j's products follow
//   in a group of their own). No group is in flight across the loop's back
//   edge: the copies that carry registers there define the in-flight
//   accumulators (C7515). Every operand register of a wgmma group
//   (descriptors, the accumulate flags, the hi and lo fragments, the
//   accumulators) is defined before the group's wgmma.fence and pinned
//   there, and pinned again after the wait that retires it: ptxas serializes
//   every wgmma of the kernel otherwise (C7513, C7515).
//
// Layout: heads are read strided straight out of (B, N, H*dh) by 3-D tensor
// maps in 16-column boxes with TMA's 32-byte swizzle (hopper.cuh); rows past N
// read as zeros. dh is padded to 16/48/80 in shared memory: the resident
// operands' padding columns are zeroed (a padded box reads the next head's
// first columns), so the products over dh see zeros there, and the streamed
// tiles' padding columns land only in output columns that are not stored.
// Keys past Nk are masked out of P in the dQ kernel's last tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;       // rows of each streamed tile (keys for dQ, queries for dK/dV)
constexpr int kStages = 4;       // streamed tiles in flight
constexpr int kNC = 2;           // consumer warpgroups, 64 resident rows each
constexpr int kRows = 64 * kNC;  // resident rows per CTA
// The consumers and a producer warpgroup that gives its registers to them
// (setmaxnreg): the CTA launches at 168 a thread (a quarter of the register
// file holds 3 warps), and 24 + 2 * 240 = 3 * 168 keeps the pool whole.
constexpr int kThreads = 128 * kNC + 128, kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// [column block][row][16 columns], TMA's 32-byte swizzle. `res0`/`res1` are
// the resident operands (Q and dO for dQ; K and V for dK/dV), `str0`/`str1`
// the streamed ones (K and V; Q and dO), lse and dd the streamed queries'
// statistics (dK/dV only).
template <int DHP>
struct Smem {
  __nv_bfloat16 res0[DHP / kAtom][kRows][kAtom];
  __nv_bfloat16 res1[DHP / kAtom][kRows][kAtom];
  __nv_bfloat16 str0[kStages][DHP / kAtom][kBlock][kAtom];
  __nv_bfloat16 str1[kStages][DHP / kAtom][kBlock][kAtom];
  float lse[kStages][kBlock], dd[kStages][kBlock];
  uint64_t res_full, full[kStages], empty[kStages];
};
template <int DHP>
constexpr int kSmemBytes = sizeof(Smem<DHP>) + 1024;  // + the slack to align it to 1024 bytes

// d = A . B^T over dh, m64n64: A and B K-major in shared memory, NB k16 steps
template <int NB>
__device__ __forceinline__ void ss_n64(float (&d)[32], const uint64_t (&a)[NB], const uint64_t (&b)[NB],
                                       uint32_t one, uint32_t zero) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    if (cb == 0) wgmma_ss_n64_zero(d, a[0], b[0], zero);
    else wgmma_ss_n64(d, a[cb], b[cb], one);
  }
}

// acc += X . T over the tile's 64 rows: X's hi and lo fragments (4 k16 steps
// of 4 registers) as the register operand, T MN-major; hi then lo per step
template <int DHP>
__device__ __forceinline__ void rs_split(float (&acc)[DHP / 2], const uint32_t (&hi)[16], const uint32_t (&lo)[16],
                                         const uint64_t (&t)[4], uint32_t one) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    wgmma_rs_mn<DHP>(acc, &hi[4 * kc], t[kc], one);
    wgmma_rs_mn<DHP>(acc, &lo[4 * kc], t[kc], one);
  }
}

// the 32 fp32 values of an m64n64 accumulator as hi and lo A fragments
__device__ __forceinline__ void split16(const float (&x)[32], uint32_t (&hi)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split_pack(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// Store acc * mul (this thread's rows g and g + 8 of its warp, from row0) as
// bf16 into (B, n, H*dh), rows below n and columns below dh.
template <int DHP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const float (&acc)[DHP / 2], float mul,
                                           long long base, long long cols, int row0, int n, int dh, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out = dst + base + (long long)row * cols;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// The shared prologue: barriers, the producer warp's loop, the consumers'
// wait for their resident rows and the padding of those. Returns false for
// threads that are done (the producer, idle warpgroups). STATS: the producer
// also writes each stage's lse and D (the dK/dV kernel's streamed queries).
template <int DHP, bool STATS>
__device__ __forceinline__ bool prologue(Smem<DHP>& sm, const CUtensorMap* tr0, const CUtensorMap* tr1,
                                         const CUtensorMap* ts0, const CUtensorMap* ts1, int r0, int n_res,
                                         int n_tiles, int col0, int b, const float* __restrict__ m,
                                         const float* __restrict__ l, const float* __restrict__ dd, long long st0,
                                         int nq, int dh) {
  constexpr int NB = DHP / kAtom;
  const int tid = threadIdx.x;
  const int active = min(kNC, (n_res - r0 + 63) / 64);  // warpgroups with a resident row below n_res
  if (tid == 0) {
    mbar_init(&sm.res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], STATS ? 33 : 1);  // the TMA bytes (and the producer warp's statistics)
      mbar_init(&sm.empty[s], 4 * active);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kNC) {  // the producer warpgroup: its first warp works, lane 0 issues every load
    setmaxnreg_dec<kProducerRegs>();
    const int lane = tid & 31;
    if (tid >= 128 * kNC + 32 || (!STATS && lane != 0)) return false;
    if (lane == 0) {
      mbar_expect_tx(&sm.res_full, sizeof(sm.res0) + sizeof(sm.res1));
      for (int c = 0; c < NB; ++c) {
        tma_load(&sm.res0[c][0][0], tr0, &sm.res_full, col0 + c * kAtom, r0, b);
        tma_load(&sm.res1[c][0][0], tr1, &sm.res_full, col0 + c * kAtom, r0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      if (lane == 0 || STATS) mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[st], sizeof(sm.str0[0]) + sizeof(sm.str1[0]));
        for (int c = 0; c < NB; ++c) {
          tma_load(&sm.str0[st][c][0][0], ts0, &sm.full[st], col0 + c * kAtom, j * kBlock, b);
          tma_load(&sm.str1[st][c][0][0], ts1, &sm.full[st], col0 + c * kAtom, j * kBlock, b);
        }
      }
      if (STATS) {  // P = ex2(s * scale * log2(e) - lse): 0 past nq
        for (int c = lane; c < kBlock; c += 32) {
          const int row = j * kBlock + c;
          float lse = INFINITY, d = 0.f;
          if (row < nq) {
            lse = fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row]));
            d = dd[st0 + row];
          }
          sm.lse[st][c] = lse;
          sm.dd[st][c] = d;
        }
        mbar_arrive(&sm.full[st]);
      }
    }
    return false;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  if (wg >= active) return false;
  mbar_wait(&sm.res_full, 0);
  __syncwarp();
  if (dh < DHP) {  // the resident operands' padding columns (one named barrier per warpgroup)
    zero_pad<DHP, kRows>(sm.res0, wg * 64, dh, tid & 127, 1 + wg);
    zero_pad<DHP, kRows>(sm.res1, wg * 64, dh, tid & 127, 1 + wg);
  }
  return true;
}

// ---- K5, dQ: 128 query rows, a loop over 64-key tiles
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int nq, int nk, int heads, int dh, float scale) {
  constexpr int NB = DHP / kAtom;
  extern __shared__ uint8_t smem_raw[];
  Smem<DHP>& sm = *reinterpret_cast<Smem<DHP>*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kRows, n_kt = (nk + kBlock - 1) / kBlock, col0 = h * dh;
  const long long st0 = (long long)bh * nq;
  // res0 = Q, res1 = dO; str0 = K, str1 = V
  if (!prologue<DHP, false>(sm, &tq, &tdo, &tk, &tv, q0, nq, n_kt, col0, b, m, l, dd, st0, nq, dh)) return;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  float lse[2], drow[2];  // P = 0 on rows past nq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < nq ? fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row])) : INFINITY;
    drow[r] = row < nq ? dd[st0 + row] : 0.f;
  }

  // descriptors (16-byte units): Q's, dO's, K's and V's k16 steps over dh are
  // their column blocks; K read MN-major steps over 16 keys (512 bytes), its
  // 16-column blocks kBlock * 32 bytes apart
  uint32_t one = 1, zero = 0;
  uint64_t dqd[NB], dod[NB];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    dqd[cb] = sdesc(&sm.res0[cb][wg * 64][0], 16, 256);
    dod[cb] = sdesc(&sm.res1[cb][wg * 64][0], 16, 256);
  }
  pin(dqd);
  pin(dod);
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t dk0 = sdesc(&sm.str0[0][0][0][0], 16, 256);
  const uint64_t dv0 = sdesc(&sm.str1[0][0][0][0], 16, 256);
  const uint64_t dkm0 = sdesc(&sm.str0[0][0][0][0], kBlock * 32, 256);
  constexpr uint64_t kStage = sizeof(sm.str0[0]) >> 4;
  uint64_t dk[NB], dv[NB], dkm[4];
  auto wait_full = [&](int j) {
    mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    __syncwarp();
  };
  auto kv_descs = [&](int j) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      dk[cb] = dk0 + (j % kStages) * kStage + cb * (kBlock * 32 >> 4);
      dv[cb] = dv0 + (j % kStages) * kStage + cb * (kBlock * 32 >> 4);
    }
    pin(dk);
    pin(dv);
  };

  const float c = scale * kLog2e;
  const int tail = nk - (n_kt - 1) * kBlock;  // valid keys of the last tile
  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  pin(acc);
  float s[32], dp[32];
  uint32_t hi[16], lo[16];

  auto k_mn = [&](int j) {  // K(j) as the MN-major B operand of dS.K
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) dkm[kc] = dkm0 + (j % kStages) * kStage + kc * (16 * 32 >> 4);
    pin(dkm);
  };

  // Tile j, as K1's loop: S(j), dP(j) and dQ += dS(j-1).K(j-1) go to the
  // tensor cores together (tile 0's third group is empty); P(j) is computed
  // while dP(j) runs and dS(j) while dQ(j-1) runs. No group is in flight
  // across the loop's back edge (the copies that carry its registers there
  // would serialize every wgmma, C7515), and no wgmma sits in a branch (C7520):
  // `prev` is a compile-time flag, tile 0 is peeled.
  auto tile = [&](int j, auto prev) {
    constexpr bool kPrev = decltype(prev)::value;
    wait_full(j);
    kv_descs(j);
    if constexpr (kPrev) k_mn(j - 1);
    pin(acc);
    pin(hi);
    pin(lo);
    wgmma_fence();
    ss_n64<NB>(s, dqd, dk, one, zero);
    wgmma_commit();
    ss_n64<NB>(dp, dod, dv, one, zero);
    wgmma_commit();
    if constexpr (kPrev) rs_split<DHP>(acc, hi, lo, dkm, one);  // dQ += dS(j-1) . K(j-1)
    wgmma_commit();
    wgmma_wait<2>();  // S(j) is done
    pin(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], c, -lse[(i >> 1) & 1]));  // P
    if (j == n_kt - 1 && tail < kBlock) {  // keys past nk
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= tail) s[i] = 0.f;
    }
    wgmma_wait<1>();  // dP(j) is done
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - drow[(i >> 1) & 1];  // dS
    wgmma_wait<0>();  // dQ(j-1) is done: K(j-1) and the fragments are free
    pin(acc);
    pin(hi);
    pin(lo);
    if (kPrev && lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);
    split16(s, hi, lo);
  };
  tile(0, std::false_type{});
  for (int j = 1; j < n_kt; ++j) tile(j, std::true_type{});
  k_mn(n_kt - 1);
  pin(acc);
  pin(hi);
  pin(lo);
  wgmma_fence();
  rs_split<DHP>(acc, hi, lo, dkm, one);  // dQ += dS(last) . K(last)
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  store_rows<DHP>(dq, acc, scale, (long long)b * nq * heads * dh + col0, (long long)heads * dh, row0, nq, dh, t4);
}

// ---- K5, dK and dV: 128 key rows, a loop over 64-query tiles
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int nq, int nk,
                     int heads, int dh, float scale) {
  constexpr int NB = DHP / kAtom;
  // the products of tile j-1 issued with tile j's S^T and dP^T: at dh 80 the
  // accumulators and both tiles' fragments do not fit in 240 registers
  constexpr bool kOverlap = DHP <= 48;
  extern __shared__ uint8_t smem_raw[];
  Smem<DHP>& sm = *reinterpret_cast<Smem<DHP>*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kRows, n_qt = (nq + kBlock - 1) / kBlock, col0 = h * dh;
  // res0 = K, res1 = V; str0 = Q, str1 = dO, with each query tile's lse and D
  if (!prologue<DHP, true>(sm, &tk, &tv, &tq, &tdo, k0, nk, n_qt, col0, b, m, l, dd, (long long)bh * nq, nq, dh))
    return;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  uint32_t one = 1, zero = 0;
  uint64_t dkd[NB], dvd[NB];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    dkd[cb] = sdesc(&sm.res0[cb][wg * 64][0], 16, 256);
    dvd[cb] = sdesc(&sm.res1[cb][wg * 64][0], 16, 256);
  }
  pin(dkd);
  pin(dvd);
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t dq0 = sdesc(&sm.str0[0][0][0][0], 16, 256);
  const uint64_t ddo0 = sdesc(&sm.str1[0][0][0][0], 16, 256);
  const uint64_t dqm0 = sdesc(&sm.str0[0][0][0][0], kBlock * 32, 256);
  const uint64_t ddom0 = sdesc(&sm.str1[0][0][0][0], kBlock * 32, 256);
  constexpr uint64_t kStage = sizeof(sm.str0[0]) >> 4;
  uint64_t dqk[NB], dok[NB], dqm[4], dom[4];
  auto wait_full = [&](int j) {
    mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    __syncwarp();
  };
  auto issue_s = [&](int j, float (&st)[32], float (&dpt)[32]) {  // S^T = K.Q(j)^T, dP^T = V.dO(j)^T
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      dqk[cb] = dq0 + (j % kStages) * kStage + cb * (kBlock * 32 >> 4);
      dok[cb] = ddo0 + (j % kStages) * kStage + cb * (kBlock * 32 >> 4);
    }
    pin(dqk);
    pin(dok);
    wgmma_fence();
    ss_n64<NB>(st, dkd, dqk, one, zero);
    wgmma_commit();
    ss_n64<NB>(dpt, dvd, dok, one, zero);
    wgmma_commit();
  };

  const float c = scale * kLog2e;
  float acc_k[DHP / 2], acc_v[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  pin(acc_k);
  pin(acc_v);
  float st[32], dpt[32];
  uint32_t phi[16], plo[16], dhi[16], dlo[16];

  auto qdo_mn = [&](int j) {  // Q(j) and dO(j) as the MN-major B operands of the products
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      dqm[kc] = dqm0 + (j % kStages) * kStage + kc * (16 * 32 >> 4);
      dom[kc] = ddom0 + (j % kStages) * kStage + kc * (16 * 32 >> 4);
    }
    pin(dqm);
    pin(dom);
  };
  auto products = [&] {  // dV += P^T . dO, dK += dS^T . Q, hi then lo
    rs_split<DHP>(acc_v, phi, plo, dom, one);
    rs_split<DHP>(acc_k, dhi, dlo, dqm, one);
  };
  auto pin_frags = [&] {
    pin(acc_k);
    pin(acc_v);
    pin(phi);
    pin(plo);
    pin(dhi);
    pin(dlo);
  };

  // Tile j, as K1's loop: S^T(j), dP^T(j) and (kOverlap) the products of tile
  // j-1 go to the tensor cores together (tile 0's third group is empty);
  // P^T(j) is computed while dP^T(j) runs and dS^T(j) while the products run.
  // Without kOverlap the products of tile j follow in a group of their own.
  // No group is in flight across the loop's back edge (C7515) and no wgmma
  // sits in a branch (C7520): `prev` is a compile-time flag, tile 0 is peeled.
  auto tile = [&](int j, auto prev) {
    constexpr bool kPrev = decltype(prev)::value;
    const int stage = j % kStages;
    wait_full(j);
    if constexpr (kPrev) qdo_mn(j - 1);
    pin_frags();
    issue_s(j, st, dpt);
    if constexpr (kPrev) products();
    wgmma_commit();
    wgmma_wait<2>();  // S^T(j) is done
    pin(st);
    // this thread's columns: queries 8jj + 2*t4 + {0, 1} of the tile
    const float* lse = sm.lse[stage];
    const float* dcol = sm.dd[stage];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 ls = *reinterpret_cast<const float2*>(&lse[8 * jj + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[4 * jj + e] = ex2(fmaf(st[4 * jj + e], c, -(e & 1 ? ls.y : ls.x)));  // P^T
    }
    wgmma_wait<1>();  // dP^T(j) is done
    pin(dpt);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d = *reinterpret_cast<const float2*>(&dcol[8 * jj + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e & 1 ? d.y : d.x));  // dS^T
    }
    wgmma_wait<0>();  // the products of tile j-1 are done: its stage and the fragments are free
    pin_frags();
    if (kPrev && lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);
    split16(st, phi, plo);
    split16(dpt, dhi, dlo);
    if constexpr (!kOverlap) {
      qdo_mn(j);
      pin_frags();
      wgmma_fence();
      products();
      wgmma_commit();
      wgmma_wait<0>();
      pin_frags();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
    }
  };
  tile(0, std::false_type{});
  for (int j = 1; j < n_qt; ++j) tile(j, std::integral_constant<bool, kOverlap>{});
  if constexpr (kOverlap) {
    qdo_mn(n_qt - 1);
    pin_frags();
    wgmma_fence();
    products();
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(acc_k);
  pin(acc_v);
  const long long base = (long long)b * nk * heads * dh + col0, cols = (long long)heads * dh;
  const int row0 = k0 + wg * 64 + warp * 16 + g;
  store_rows<DHP>(dk_out, acc_k, scale, base, cols, row0, nk, dh, t4);
  store_rows<DHP>(dv_out, acc_v, 1.f, base, cols, row0, nk, dh, t4);
}

// ---- host side (tensor maps: hopper.cuh)

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *dd;
  void *dq, *dk, *dv;
  int b, nq, nk, heads, dh;
  float scale;
};

template <int DHP, bool DKV>
int launch(const Args& a, cudaStream_t stream) {
  if (const cudaError_t err = bind_device(a.q); err != cudaSuccess) return static_cast<int>(err);
  const int cols = a.heads * a.dh;
  // the resident operands in boxes of kRows rows, the streamed ones of kBlock
  const int rq = DKV ? kBlock : kRows, rk = DKV ? kRows : kBlock;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(&tq, a.q, a.b, a.nq, cols, rq) || !tensor_map(&tdo, a.dout, a.b, a.nq, cols, rq) ||
      !tensor_map(&tk, a.k, a.b, a.nk, cols, rk) || !tensor_map(&tv, a.v, a.b, a.nk, cols, rk))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kSmemBytes<DHP>;
  const int n_res = DKV ? a.nk : a.nq;
  dim3 grid((n_res + kRows - 1) / kRows, a.b * a.heads);
  if constexpr (DKV) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_bwd_dkv_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dkv_kernel<DHP><<<grid, kThreads, kSmem, stream>>>(
        tk, tv, tq, tdo, a.m, a.l, a.dd, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
        a.nq, a.nk, a.heads, a.dh, a.scale);
  } else {
    static const cudaError_t attr =
        cudaFuncSetAttribute(flash_bwd_dq_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dq_kernel<DHP><<<grid, kThreads, kSmem, stream>>>(
        tq, tdo, tk, tv, a.m, a.l, a.dd, static_cast<__nv_bfloat16*>(a.dq), a.nq, a.nk, a.heads, a.dh, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int dispatch(const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dh % 8 != 0 || a.nq < 1 || a.nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.dh + 15) / 16 * 16) {
    case 16: return launch<16, DKV>(a, st);
    case 48: return launch<48, DKV>(a, st);
    case 80: return launch<80, DKV>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: (b, nq, heads * dh); k, v: (b, nk, heads * dh); bf16, contiguous,
// 16-byte aligned; m, l, dd: (b * heads, nq) fp32 (m and l from K4 or K7, dd =
// rowsum(dO * O) per head and row); dh a multiple of 8 that pads to 16, 48 or
// 80. Each returns cudaGetLastError() after its launch.

// K5, dQ: (b, nq, heads * dh).
extern "C" int vface_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                                 const void* m, const void* l, const void* dd, void* dq, int b,
                                                 int nq, int nk, int heads, int dh, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const float*>(dd), dq, nullptr, nullptr, b, nq, nk, heads, dh, scale};
  return dispatch<false>(a, stream);
}

// K5, dK and dV: (b, nk, heads * dh) each.
extern "C" int vface_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                                  const void* m, const void* l, const void* dd, void* dk, void* dv,
                                                  int b, int nq, int nk, int heads, int dh, float scale,
                                                  void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const float*>(dd), nullptr, dk, dv, b, nq, nk, heads, dh, scale};
  return dispatch<true>(a, stream);
}

// Dynamic shared memory of either kernel at head width dh, in bytes (0 if no
// instantiation takes it).
extern "C" int vface_flash_attention_bwd_smem_bytes(int dh) {
  switch ((dh + 15) / 16 * 16) {
    case 16: return kSmemBytes<16>;
    case 48: return kSmemBytes<48>;
    case 80: return kSmemBytes<80>;
    default: return 0;
  }
}
