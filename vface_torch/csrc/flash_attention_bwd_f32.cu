// Flash attention backward with fp32 operands for Hopper (sm_90a), on the
// tensor cores as 3xTF32: K5 on fp32.
//
// Replaces, for fp32 operands, vface_tpu/ops/pallas_attention.py::
// flash_attention_bwd and its two kernels, _flash_bwd_dq_kernel (dQ; a loop
// over keys) and _flash_bwd_dkv_kernel (dK, dV; a loop over queries), which
// cast every operand to fp32: P = exp(s * scale - m) / l from the forward's
// row statistics (m in the units K4/K7 write it in: the max of the scaled
// scores), dP = dO . V^T, dS = P * (dP - D) with D = rowsum(dO * O);
// dQ = scale * dS . K, dK = scale * dS^T . Q, dV = P^T . dO, all fp32, with
// Nq != Nk allowed. P and dS never touch device memory, and each output is
// summed in a fixed order by one CTA: two launches give the same bits.
//
// What bounds it on the H100: five N^2-products (2*Nq*Nk*dh FLOPs each per
// head), which need fp32-accurate products: three tf32 terms of hi + lo
// splits each, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3xTF32, as in
// flash_attention_f32.cu), 165 TFLOP/s of fp32-accurate products on the
// tensor cores against the CUDA cores' 67; 0.325 ms at the UNet's ds1
// training site (1, 4096, 320), h 8.
//
// The design, from K5's (flash_attention_bwd.cu) and the fp32 forward's:
// * tf32 wgmma reads shared memory K-major only, so every operand comes in
//   the layout its product contracts over. A split pass (split_planes_kernel)
//   writes, once per call, each T-row tile of Q, K, V and dO as four tf32
//   planes: hi and lo as [dh/8][T rows][8] (the products over dh: S, dP), and
//   hi and lo of the transpose as [T/8 row groups][dh][8] (the products over
//   the tile's rows: dS.K, P^T.dO, dS^T.Q), each group of 8 rows in the order
//   0 2 4 6 1 3 5 7, so that an m64 accumulator over those rows is the tf32 A
//   fragment as it stands (its registers hold rows 2*t4 and 2*t4 + 1 of each 8
//   where the fragment takes t4 and t4 + 4). The pass writes every 32-byte row
//   already in TMA's 32-byte swizzle (16-byte halves swapped on rows 4-7 of
//   each 8), so one 1-D bulk copy per plane set lands a tile in shared memory
//   as wgmma reads it; rows past N are zeros.
// * One CTA owns 64 rows of one (batch, head): the dQ kernel 64 queries,
//   holding Q's and dO's hi and lo planes in shared memory and streaming K's
//   four planes and V's two; the dK/dV kernel 64 keys, holding K's and V's and
//   streaming Q's and dO's four each. One consumer warpgroup runs every
//   product; the first thread of a producer warpgroup keeps a ring of stages
//   filled by bulk copies completed on mbarriers (full: the bytes landed and,
//   for dK/dV, the stage's statistics are written; empty: every consumer warp
//   is done with it). A tile is T = 64 rows, 32 at dh 80, where two 64-row
//   tiles' planes leave no room for a second stage (227 KB), and in the
//   halves of dh 160.
// * The products over dh (S, dP; S^T, dP^T) read both operands from shared
//   memory (ss); the products over the tile's rows take P or dS, split in
//   registers into hi and lo A fragments, against the transposed planes.
//   Each tile's three-term product goes to a fresh accumulator that the CUDA
//   cores add to the running output: the tensor cores' fp32 sums do not round
//   to nearest, and over all of a row's tiles they drift.
// * The dK/dV kernel needs the statistics of its streamed queries by column:
//   the producer warp writes each stage's lse = m * log2(e) + log2(l) and D for
//   the tile's queries beside its planes (+inf and 0 past Nq, so P = 0 there).
//   The dQ kernel's threads hold their two rows' lse and D; keys past Nk are
//   masked out of P in the last tile. P is one FFMA and one ex2 a score.
// * Every operand register of a wgmma group (descriptors, the accumulate
//   flag, the fragments, the accumulators) is defined before the group's
//   wgmma.fence and pinned there, and every group is waited before the loop's
//   back edge: ptxas serializes every wgmma of a kernel otherwise (C7513,
//   C7515). At dh <= 40 the S and dP groups go out together; at dh 80 their
//   descriptors do not fit beside each other, and the row products run in two
//   halves of 40 columns.
// dh is one of 16, 32, 40, 80 and 160 (the JAX tests' widths and the UNet's
// ds1, ds2 and ds4); other widths are refused. dh 160 runs on a cluster of
// two CTAs per 64 resident rows, each over half of dh (bwd_f32_cluster_kernel
// below the others): see there.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kRes = 64;       // resident rows per CTA: one consumer warpgroup
constexpr int kThreads = 256;  // the consumer warpgroup and a producer warpgroup
constexpr int kSmemMax = 232448;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr int kT = DH >= 80 ? 32 : 64;  // rows of a streamed tile (and of the split pass's tiles)

// Shared memory of the dQ (!DKV) or dK/dV kernel at head width DH.
template <int DH, bool DKV>
struct Cfg {
  static constexpr int T = kT<DH>;
  static constexpr int kPlane = T * DH;           // values of a streamed plane
  static constexpr int kResPlane = kRes * DH;     // values of a resident plane
  static constexpr int kStrPlanes = DKV ? 8 : 6;  // Q's and dO's four each; K's four and V's hi, lo
  static constexpr int kStatT = DKV ? T : 1;      // the streamed queries' statistics (dK/dV)
  static constexpr int kStageBytes = kStrPlanes * kPlane * 4 + 2 * kStatT * 4;
  static constexpr int kFree = kSmemMax - 4 * kResPlane * 4 - 2048;  // barriers and alignment slack
  static constexpr int kStages = kFree / kStageBytes > 4 ? 4 : kFree / kStageBytes;
  static_assert(kStages >= 1, "no room for a stage");
  struct Smem {
    float res[4][kResPlane];  // resident X0 hi, X0 lo, X1 hi, X1 lo, each [DH/8][64][8]
    float str[kStages][kStrPlanes][kPlane];
    float lse[kStages][kStatT], dd[kStages][kStatT];
    uint64_t res_full, full[kStages], empty[kStages];
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the slack to align it to 1024 bytes
};

// split tiles of a tensor of n rows: whole 64-row blocks, so that every
// resident block exists (zeros past n)
template <int DH>
__host__ __device__ constexpr int tiles(int n) {
  return (n + kRes - 1) / kRes * (kRes / kT<DH>);
}

// Position i of a group of 8 rows of a transposed plane holds row perm8(i)
__device__ __forceinline__ int perm8(int i) { return 2 * (i & 3) + (i >> 2); }

// The split pass: one CTA per (tile j of T rows, batch * head) writes the
// tile's four planes of x (b, n, heads * DH) to planes[bh][j][4][T * DH].
template <int DH>
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ x, float* __restrict__ planes, int n, int heads) {
  constexpr int T = kT<DH>, P = T * DH;
  __shared__ float sx[T][DH + 1];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const long long cols = (long long)heads * DH;
  for (int i = threadIdx.x; i < P; i += 256) {
    const int r = i / DH, d = i - r * DH, row = j * T + r;
    sx[r][d] = row < n ? x[((long long)b * n + row) * cols + h * DH + d] : 0.f;
  }
  __syncthreads();
  float* out = planes + ((long long)bh * gridDim.x + j) * 4 * P;
  for (int i = threadIdx.x; i < P; i += 256) {
    // 32-byte row R of the plane; its slot i & 7 holds logical column c (the
    // 16-byte halves swapped where bit 2 of R is set: TMA's 32-byte swizzle)
    const int R = i >> 3, c = (i & 7) ^ (((R >> 2) & 1) << 2);
    uint32_t hi, lo;
    split_tf32(sx[R % T][8 * (R / T) + c], hi, lo);  // R = column block * T + row
    out[i] = __uint_as_float(hi);
    out[P + i] = __uint_as_float(lo);
    const int kg = R / DH, d = R - kg * DH;  // R = row group * DH + column
    split_tf32(sx[8 * kg + perm8(c)][d], hi, lo);
    out[2 * P + i] = __uint_as_float(hi);
    out[3 * P + i] = __uint_as_float(lo);
  }
}

// d (+)= A . B^T, m64nNk8 tf32 (N = 64 or 32), both operands K-major in shared memory
template <int N, bool ZERO = false>
__device__ __forceinline__ void ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db, uint32_t flag) {
  if constexpr (N == 64) wgmma_tf32_ss_n64<ZERO>(d, da, db, flag);
  else wgmma_tf32_ss_n32<ZERO>(d, da, db, flag);
}

// d = A . B^T over dh as three tf32 terms (A_lo.B_hi + A_hi.B_lo + A_hi.B_hi):
// a and b hold the hi planes' NB k8 steps, then the lo planes'
template <int N, int NB>
__device__ __forceinline__ void ss_dh(float (&d)[N / 2], const uint64_t (&a)[2 * NB], const uint64_t (&b)[2 * NB],
                                      uint32_t one, uint32_t zero) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    if (cb == 0) ss_tf32<N, true>(d, a[NB], b[0], zero);
    else ss_tf32<N>(d, a[NB + cb], b[cb], one);
  }
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) ss_tf32<N>(d, a[cb], b[NB + cb], one);
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) ss_tf32<N>(d, a[cb], b[cb], one);
}

// acc = X . Y over the tile's rows as three tf32 terms: X's hi and lo A
// fragments (KG k8 steps of 4 registers), y the transposed planes' hi steps,
// then the lo steps
template <int DN, int KG>
__device__ __forceinline__ void rs_rows(float (&acc)[DN / 2], const uint32_t (&hi)[4 * KG],
                                        const uint32_t (&lo)[4 * KG], const uint64_t (&y)[2 * KG], uint32_t one,
                                        uint32_t zero) {
#pragma unroll
  for (int kg = 0; kg < KG; ++kg) {
    if (kg == 0) wgmma_tf32_dh<DN, true>(acc, &lo[0], y[0], zero);
    else wgmma_tf32_dh<DN>(acc, &lo[4 * kg], y[kg], one);
  }
#pragma unroll
  for (int kg = 0; kg < KG; ++kg) wgmma_tf32_dh<DN>(acc, &hi[4 * kg], y[KG + kg], one);
#pragma unroll
  for (int kg = 0; kg < KG; ++kg) wgmma_tf32_dh<DN>(acc, &hi[4 * kg], y[kg], one);
}

// an m64nT accumulator as hi and lo tf32 A fragments over its T columns
template <int T>
__device__ __forceinline__ void split_frags(const float (&x)[T / 2], uint32_t (&hi)[T / 2], uint32_t (&lo)[T / 2]) {
#pragma unroll
  for (int kg = 0; kg < T / 8; ++kg) {
    split_tf32(x[4 * kg], hi[4 * kg], lo[4 * kg]);
    split_tf32(x[4 * kg + 2], hi[4 * kg + 1], lo[4 * kg + 1]);
    split_tf32(x[4 * kg + 1], hi[4 * kg + 2], lo[4 * kg + 2]);
    split_tf32(x[4 * kg + 3], hi[4 * kg + 3], lo[4 * kg + 3]);
  }
}

// Bulk-copy the resident planes (hi, lo of x0, then of x1) of the 64 rows
// from split tile t0 on into res; with 32-row tiles each column block's rows
// come in two pieces.
template <int DH>
__device__ __forceinline__ void load_resident(float (*res)[kRes * DH], const float* x0, const float* x1,
                                              long long tile0, uint64_t* bar) {
  constexpr int T = kT<DH>, P = T * DH;
#pragma unroll
  for (int u = 0; u < kRes / T; ++u)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float* src = (p < 2 ? x0 : x1) + ((tile0 + u) * 4 + (p & 1)) * P;
      if constexpr (T == kRes) {
        bulk_load(res[p], src, P * 4, bar);
      } else {
        for (int cb = 0; cb < DH / 8; ++cb) bulk_load(res[p] + (cb * kRes + u * T) * 8, src + cb * T * 8, T * 32, bar);
      }
    }
}

// Store run * mul (this thread's rows row0 and row0 + 8 below n) into (b, n, heads * DH)
template <int DH>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&run)[DH / 2], float mul,
                                           long long base, long long cols, int row0, int n, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    float* o = dst + base + (long long)row * cols;
#pragma unroll
    for (int jc = 0; jc < DH / 8; ++jc)
      *reinterpret_cast<float2*>(o + 8 * jc + 2 * t4) = make_float2(run[4 * jc + 2 * r] * mul, run[4 * jc + 2 * r + 1] * mul);
  }
}

// ---- dQ: 64 query rows, a loop over T-key tiles
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_f32_kernel(const float* __restrict__ pq, const float* __restrict__ pdo, const float* __restrict__ pk,
                  const float* __restrict__ pv, const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ dd, float* __restrict__ dq, int nq, int nk, int heads, float scale) {
  using C = Cfg<DH, false>;
  constexpr int T = C::T, P = C::kPlane, S = C::kStages, NB = DH / 8, KG = T / 8;
  constexpr int NH = DH == 80 ? 2 : 1, DN = DH / NH;  // the row product's output columns per group
  constexpr bool kJoint = DH <= 40;                    // S and dP issued together
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<typename C::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x, bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kRes, n_kt = (nk + T - 1) / T;
  const long long kt0 = (long long)bh * tiles<DH>(nk);  // K's and V's first tile

  if (tid == 0) {
    mbar_init(&sm.res_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup: its first thread issues every copy
    if (tid == 128) {
      mbar_expect_tx(&sm.res_full, sizeof(sm.res));
      load_resident<DH>(sm.res, pq, pdo, (long long)bh * tiles<DH>(nq) + q0 / T, &sm.res_full);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        mbar_wait(&sm.empty[st], ((j / S) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 6 * P * 4);
        bulk_load(sm.str[st][0], pk + (kt0 + j) * 4 * P, 4 * P * 4, &sm.full[st]);  // K: hi, lo, T hi, T lo
        bulk_load(sm.str[st][4], pv + (kt0 + j) * 4 * P, 2 * P * 4, &sm.full[st]);  // V: hi, lo
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const long long st0 = (long long)bh * nq;
  float lse[2], drow[2];  // P = 0 on rows past nq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < nq ? fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row])) : INFINITY;
    drow[r] = row < nq ? dd[st0 + row] : 0.f;
  }
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));
  // descriptors (16-byte units): a resident plane's k8 step cb is its 64-row
  // column block; a streamed plane's over dh its T-row block; a transposed
  // plane's k8 step kg is its row group, DH rows of 32 bytes
  const uint64_t dres = sdesc(&sm.res[0][0], 16, 256), dstr = sdesc(&sm.str[0][0][0], 16, 256);
  constexpr uint64_t kResPl = C::kResPlane * 4 >> 4, kPl = P * 4 >> 4, kStg = sizeof(sm.str[0]) >> 4;
  // resident operand x (0: Q, 1: dO) against streamed plane pair y (0: K, 4: V)
  auto dh_descs = [&](uint64_t (&da)[2 * NB], uint64_t (&db)[2 * NB], int x, int y, int st) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        da[p * NB + cb] = dres + (2 * x + p) * kResPl + cb * (kRes * 32 >> 4);
        db[p * NB + cb] = dstr + st * kStg + (y + p) * kPl + cb * (T * 32 >> 4);
      }
    pin(da);
    pin(db);
  };

  const float c = scale * kLog2e;
  const int tail = nk - (n_kt - 1) * T;  // valid keys of the last tile
  float run[DH / 2], acc[DN / 2], s[T / 2], dp[T / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) run[i] = 0.f;
  uint32_t fhi[T / 2], flo[T / 2];
  mbar_wait(&sm.res_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % S;
    mbar_wait(&sm.full[st], (j / S) & 1);
    __syncwarp();
    // S = Q.K^T and dP = dO.V^T
    if constexpr (kJoint) {
      uint64_t das[2 * NB], dbs[2 * NB], dap[2 * NB], dbp[2 * NB];
      dh_descs(das, dbs, 0, 0, st);
      dh_descs(dap, dbp, 1, 4, st);
      wgmma_fence();
      ss_dh<T, NB>(s, das, dbs, one, zero);
      wgmma_commit();
      ss_dh<T, NB>(dp, dap, dbp, one, zero);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      uint64_t da[2 * NB], db[2 * NB];
      dh_descs(da, db, 0, 0, st);
      wgmma_fence();
      ss_dh<T, NB>(s, da, db, one, zero);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      dh_descs(da, db, 1, 4, st);
      wgmma_fence();
      ss_dh<T, NB>(dp, da, db, one, zero);
      wgmma_commit();
    }
    pin(s);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = ex2(fmaf(s[i], c, -lse[(i >> 1) & 1]));  // P
    if (j == n_kt - 1 && tail < T) {  // keys past nk
#pragma unroll
      for (int i = 0; i < T / 2; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= tail) s[i] = 0.f;
    }
    wgmma_wait<0>();  // dP is done
    pin(dp);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] *= dp[i] - drow[(i >> 1) & 1];  // dS
    split_frags<T>(s, fhi, flo);
    pin(fhi);
    pin(flo);
    // dQ += dS . K, K^T's planes (2: hi, 3: lo), in NH groups of DN columns
#pragma unroll
    for (int hb = 0; hb < NH; ++hb) {
      uint64_t dk[2 * KG];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          dk[p * KG + kg] = dstr + st * kStg + (2 + p) * kPl + kg * (DH * 32 >> 4) + hb * (DN * 32 >> 4);
      pin(dk);
      wgmma_fence();
      rs_rows<DN, KG>(acc, fhi, flo, dk, one, zero);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) run[hb * DN / 2 + i] += acc[i];
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
  store_rows<DH>(dq, run, scale, (long long)b * nq * heads * DH + h * DH, (long long)heads * DH, row0, nq, t4);
}

// ---- dK and dV: 64 key rows, a loop over T-query tiles
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_f32_kernel(const float* __restrict__ pk, const float* __restrict__ pv, const float* __restrict__ pq,
                   const float* __restrict__ pdo, const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ dd, float* __restrict__ dk_out, float* __restrict__ dv_out, int nq,
                   int nk, int heads, float scale) {
  using C = Cfg<DH, true>;
  constexpr int T = C::T, P = C::kPlane, S = C::kStages, NB = DH / 8, KG = T / 8;
  constexpr int NH = DH == 80 ? 2 : 1, DN = DH / NH;
  constexpr bool kJoint = DH <= 40;  // S^T and dP^T issued together
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<typename C::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x, bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kRes, n_qt = (nq + T - 1) / T;
  const long long qt0 = (long long)bh * tiles<DH>(nq), st0 = (long long)bh * nq;

  if (tid == 0) {
    mbar_init(&sm.res_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 33);  // the copies' bytes, and the producer warp's statistics
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup: its first warp works, lane 0 issues every copy
    if (tid >= 160) return;
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect_tx(&sm.res_full, sizeof(sm.res));
      load_resident<DH>(sm.res, pk, pv, (long long)bh * tiles<DH>(nk) + k0 / T, &sm.res_full);
    }
    for (int j = 0; j < n_qt; ++j) {
      const int st = j % S;
      mbar_wait(&sm.empty[st], ((j / S) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[st], 8 * P * 4);
        bulk_load(sm.str[st][0], pq + (qt0 + j) * 4 * P, 4 * P * 4, &sm.full[st]);   // Q: hi, lo, T hi, T lo
        bulk_load(sm.str[st][4], pdo + (qt0 + j) * 4 * P, 4 * P * 4, &sm.full[st]);  // dO: the same
      }
      for (int cq = lane; cq < T; cq += 32) {  // P = ex2(s * scale * log2(e) - lse): 0 past nq
        const int row = j * T + cq;
        sm.lse[st][cq] = row < nq ? fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row])) : INFINITY;
        sm.dd[st][cq] = row < nq ? dd[st0 + row] : 0.f;
      }
      mbar_arrive(&sm.full[st]);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t dres = sdesc(&sm.res[0][0], 16, 256), dstr = sdesc(&sm.str[0][0][0], 16, 256);
  constexpr uint64_t kResPl = C::kResPlane * 4 >> 4, kPl = P * 4 >> 4, kStg = sizeof(sm.str[0]) >> 4;
  // resident operand x (0: K, 1: V) against streamed plane pair y (0: Q, 4: dO)
  auto dh_descs = [&](uint64_t (&da)[2 * NB], uint64_t (&db)[2 * NB], int x, int y, int st) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        da[p * NB + cb] = dres + (2 * x + p) * kResPl + cb * (kRes * 32 >> 4);
        db[p * NB + cb] = dstr + st * kStg + (y + p) * kPl + cb * (T * 32 >> 4);
      }
    pin(da);
    pin(db);
  };
  // out += X . Y over the tile's queries, Y the transposed planes from y (2: Q^T, 6: dO^T)
  auto rows_product = [&](float (&out)[DH / 2], float (&acc)[DN / 2], uint32_t (&hi)[T / 2], uint32_t (&lo)[T / 2],
                          int y, int st) {
    pin(hi);
    pin(lo);
#pragma unroll
    for (int hb = 0; hb < NH; ++hb) {
      uint64_t dy[2 * KG];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          dy[p * KG + kg] = dstr + st * kStg + (y + p) * kPl + kg * (DH * 32 >> 4) + hb * (DN * 32 >> 4);
      pin(dy);
      wgmma_fence();
      rs_rows<DN, KG>(acc, hi, lo, dy, one, zero);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) out[hb * DN / 2 + i] += acc[i];
    }
  };

  const float c = scale * kLog2e;
  float run_k[DH / 2], run_v[DH / 2], acc[DN / 2], s[T / 2], dp[T / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) run_k[i] = run_v[i] = 0.f;
  uint32_t fhi[T / 2], flo[T / 2];
  mbar_wait(&sm.res_full, 0);

  for (int j = 0; j < n_qt; ++j) {
    const int st = j % S;
    mbar_wait(&sm.full[st], (j / S) & 1);
    __syncwarp();
    // S^T = K.Q^T and dP^T = V.dO^T
    if constexpr (kJoint) {
      uint64_t das[2 * NB], dbs[2 * NB], dap[2 * NB], dbp[2 * NB];
      dh_descs(das, dbs, 0, 0, st);
      dh_descs(dap, dbp, 1, 4, st);
      wgmma_fence();
      ss_dh<T, NB>(s, das, dbs, one, zero);
      wgmma_commit();
      ss_dh<T, NB>(dp, dap, dbp, one, zero);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      uint64_t da[2 * NB], db[2 * NB];
      dh_descs(da, db, 0, 0, st);
      wgmma_fence();
      ss_dh<T, NB>(s, da, db, one, zero);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      dh_descs(da, db, 1, 4, st);
      wgmma_fence();
      ss_dh<T, NB>(dp, da, db, one, zero);
      wgmma_commit();
    }
    pin(s);
    // this thread's columns: queries 8jj + 2*t4 + {0, 1} of the tile
    const float* lse = sm.lse[st];
    const float* dcol = sm.dd[st];
#pragma unroll
    for (int jj = 0; jj < KG; ++jj) {
      const float2 ls = *reinterpret_cast<const float2*>(&lse[8 * jj + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * jj + e] = ex2(fmaf(s[4 * jj + e], c, -(e & 1 ? ls.y : ls.x)));  // P^T
    }
    wgmma_wait<0>();  // dP^T is done
    pin(dp);
#pragma unroll
    for (int jj = 0; jj < KG; ++jj) {
      const float2 d = *reinterpret_cast<const float2*>(&dcol[8 * jj + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - (e & 1 ? d.y : d.x));  // dS^T
    }
    split_frags<T>(s, fhi, flo);
    rows_product(run_v, acc, fhi, flo, 6, st);  // dV += P^T . dO
    split_frags<T>(dp, fhi, flo);
    rows_product(run_k, acc, fhi, flo, 2, st);  // dK += dS^T . Q
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
  const long long base = (long long)b * nk * heads * DH + h * DH, cols = (long long)heads * DH;
  const int row0 = k0 + warp * 16 + g;
  store_rows<DH>(dk_out, run_k, scale, base, cols, row0, nk, t4);
  store_rows<DH>(dv_out, run_v, 1.f, base, cols, row0, nk, t4);
}

// ---- dh 160 (SD-v1's ds4 sites above 512^2): a cluster of two CTAs per 64
// resident rows, each over half of dh's columns
//
// What bounds it on the H100: at (1, 1024, 1280) h8 the five products as
// three tf32 terms each are 0.081 ms on the tensor cores (0.200 on the CUDA
// cores' FFMA line), and each CTA streams its operands' planes (16 bytes an
// element) from L2. At dh 160 the 64 resident rows' four tf32 planes are 160
// KB, and beside them no streamed stage fits; the first form at this width
// read the resident operand's fragments from its planes in global memory two
// k8 steps at a time, each group drained before the next, one 32-row stage in
// flight, and split dK/dV by output columns into two CTAs that both computed
// S^T and dP^T: 1.017-1.047 ms in all at (1, 1024, 1280) against SDPA's
// backward at 0.539-0.638 (NVIDIA H100 80GB HBM3 at 700 W).
//
// The design (route (a) of three weighed: a two-CTA cluster, the resident
// operand stored once as raw fp32, or two consumer warpgroups that split the
// products; only the cluster leaves room for two stages of 32-row tiles):
// * CTA r of a cluster of two owns dh's columns 80r .. 80r + 79 of 64
//   resident rows: the split pass writes each operand as two heads of width
//   80 (split_planes_kernel<80> over 2 * heads), so a CTA's planes are the
//   dh-80 kernels' and its products over the tile's rows are theirs.
// * The resident operands stay in shared memory for the whole loop, each
//   thread's A fragments of every k8 step as fp32 hi + lo (40 KB for both
//   operands), split into tf32 hi and lo in registers as they are read. The
//   streamed planes come in two rings of two slots, the planes over dh and
//   the transposed planes (40 + 40 KB a tile for dK/dV, 40 + 20 for dQ), so
//   tile j + 1's planes over dh land while tile j's transposed ones are used.
// * S (S^T) and dP (dP^T) over the CTA's 80 columns run in five groups of two
//   k8 steps, both products a group, accumulated on the tensor cores over the
//   80 columns as the dh-80 kernels accumulate theirs. Each CTA sends its two
//   partial tiles into the other's shared memory with asynchronous stores
//   that complete on the other's mbarrier (st.async: no release fence on the
//   data's way) and adds the other's: a + b on one CTA and b + a on the other
//   are the same bits, so both compute the same P and dS, S^T and dP^T once
//   per tile pair across the cluster. Tile j + 1's products over dh run
//   while tile j's partials cross; a second mbarrier tells a CTA that its
//   peer has read the last partials, before it writes the next (and before
//   it leaves). On the card (NVIDIA H100 80GB HBM3 at 700 W), the exchange
//   as plain stores released by every thread right after them cost each
//   kernel ~40 % (0.262 -> 0.157 ms for dQ at (1, 1024, 1280) without it);
//   asynchronous stores a tile ahead cost ~25 % (0.204 ms).
// * Each CTA then adds its 80 columns of dQ (or dK and dV) as the dh-80
//   kernels do: each tile's product into a fresh accumulator that the CUDA
//   cores add to the running output. Every output is summed in one fixed
//   order by one CTA.
// * Each kernel is 144 CTAs on 132 SMs at (1, 576, 1280): the dK/dV kernel
//   is launched as the dQ kernel's programmatic dependent (it reads only the
//   split pass's planes), so it starts on the SMs that dQ's last wave leaves
//   idle, and waits for dQ before it completes.
// At (1, 1024, 1280): dQ 0.200, dK/dV 0.227, the split pass 0.043 ms, the
// whole call 0.464 ms of device time against the first form's 0.997-1.000 and
// SDPA's backward 0.508-0.509; at (1, 576, 1280) 0.222-0.224 against 0.555-
// 0.558 and 0.288-0.289 (NVIDIA H100 80GB HBM3 at 700 W;
// vface_torch/bench/attn_bwd_wide.py, both forms in one run). Still one
// consumer warpgroup per SM: its chain per tile (five drained groups, the
// exchange, two or four drained groups over the rows) keeps the tensor
// cores ~20 % busy.

constexpr int kHalf = 80;  // dh columns per CTA of a cluster

// Shared memory of the cluster dQ (!DKV) or dK/dV kernel, the streamed
// planes first (1024-byte aligned, as the bulk copies land them) in two rings
// of two slots: dh[slot] the streamed operands' planes over dh (Y0 hi, lo,
// Y1 hi, lo: K and V, or Q and dO), rw[slot] their transposed planes (K^T
// hi, lo; or Q^T hi, lo, dO^T hi, lo) with, for dK/dV, the queries'
// statistics; then the resident A fragments ([operand][k8 step][thread],
// fp32 hi + lo) and the peer's partials (x[0..3] S, x[4..7] dP, [8][thread]).
template <bool DKV>
struct ClusterCfg {
  static constexpr int T = kT<kHalf>, P = T * kHalf, S = 2;
  static constexpr int kRwPlanes = DKV ? 4 : 2;
  static constexpr int kStatT = DKV ? T : 1;
  struct Smem {
    float dh[S][4][P];
    float rw[S][kRwPlanes][P];
    float4 res[2][kHalf / 8][128];
    float4 x[8][128];
    float lse[S][kStatT], dd[S][kStatT];
    uint64_t dh_full[S], dh_empty[S], rw_full[S], rw_empty[S], xfull, xempty;
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;
  static_assert(kSmemBytes <= kSmemMax, "over the shared memory of a block");
};

// The hi and lo tf32 A fragments of k8 step cb of a resident operand, read
// from its split planes x (planes[bh][tile][4][T * DH]): this thread's rows
// rr and rr + 8 of the 64 from tile tile0 on. Row R of a plane is column
// block * T + the tile's row; its slot c ^ 4 * (bit 2 of R) holds column
// 8 * block + c (the pass writes TMA's 32-byte swizzle).
template <int DH>
__device__ __forceinline__ void load_frags(const float* __restrict__ x, long long tile0, int rr, int t4, int cb,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int T = kT<DH>, P = T * DH;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = rr + 8 * (e & 1), c = t4 + 4 * (e >> 1);
    const int R = cb * T + row % T;
    const float* at = x + (tile0 + row / T) * 4 * P + R * 8 + (c ^ (((R >> 2) & 1) << 2));
    hi[e] = __float_as_uint(at[0]);
    lo[e] = __float_as_uint(at[P]);
  }
}

// ---- K5 on fp32 at dh 160: dQ (!DKV: 64 query rows, a loop over 32-key
// tiles) or dK and dV (64 key rows, a loop over 32-query tiles), dh's columns
// 80 * rank on, rank = this CTA's in its cluster of two. x0, x1: the resident
// operands' planes (Q and dO, or K and V), y0, y1 the streamed ones (K and V,
// or Q and dO), each [b * heads * 2][tiles][4][T * 80]
template <bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
bwd_f32_cluster_kernel(const float* __restrict__ x0, const float* __restrict__ x1, const float* __restrict__ y0,
                       const float* __restrict__ y1, const float* __restrict__ m, const float* __restrict__ l,
                       const float* __restrict__ dd, float* __restrict__ out0, float* __restrict__ out1, int nq,
                       int nk, int heads, float scale) {
  using C = ClusterCfg<DKV>;
  constexpr int T = C::T, P = C::P, S = C::S, NB = kHalf / 8, KG = T / 8, DN = 40, NH = kHalf / DN;
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<typename C::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x, bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1u;
  const int r0 = (blockIdx.x >> 1) * kRes, n_t = ((DKV ? nq : nk) + T - 1) / T;
  const long long bhv = 2LL * bh + rank;  // the split pass's head of this CTA's columns
  const long long rt0 = bhv * tiles<kHalf>(DKV ? nk : nq) + r0 / T;  // the resident rows' first tile
  const long long yt0 = bhv * tiles<kHalf>(DKV ? nq : nk);            // the streamed operands' first tile
  const long long st0 = (long long)bh * nq;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.dh_full[s], 1);           // the copies' bytes
      mbar_init(&sm.rw_full[s], DKV ? 33 : 1);  // the copies' bytes (and the producer warp's statistics)
      mbar_init(&sm.dh_empty[s], 4);          // one arrival per consumer warp
      mbar_init(&sm.rw_empty[s], 4);
    }
    mbar_init(&sm.xfull, 1);   // the peer's partials: their bytes (st_async_peer), armed by thread 0
    mbar_init(&sm.xempty, 4);  // the peer has read this CTA's partials: one arrival per peer consumer warp
    mbar_expect_tx(&sm.xfull, sizeof(sm.x));  // tile 0's
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers are initialised before either arrives on the other's
  if constexpr (!DKV) dependents_may_start();  // the dK/dV kernel may start on idle SMs

  if (tid >= 128) {  // the producer warpgroup: its first warp works, lane 0 issues every copy
    if (tid >= 160 || (!DKV && tid != 128)) return;
    const int lane = tid & 31;
    for (int j = 0; j < n_t; ++j) {  // tile j's planes over dh, then its transposed planes
      const int st = j % S;
      const uint32_t parity = ((j / S) & 1) ^ 1;
      const float* t0 = y0 + (yt0 + j) * 4 * P;
      const float* t1 = y1 + (yt0 + j) * 4 * P;
      if (lane == 0) {
        mbar_wait(&sm.dh_empty[st], parity);
        mbar_expect_tx(&sm.dh_full[st], 4 * P * 4);
        bulk_load(sm.dh[st][0], t0, 2 * P * 4, &sm.dh_full[st]);  // Y0 hi, lo
        bulk_load(sm.dh[st][2], t1, 2 * P * 4, &sm.dh_full[st]);  // Y1 hi, lo
      }
      if (lane == 0 || DKV) mbar_wait(&sm.rw_empty[st], parity);
      if (lane == 0) {
        mbar_expect_tx(&sm.rw_full[st], C::kRwPlanes * P * 4);
        bulk_load(sm.rw[st][0], t0 + 2 * P, 2 * P * 4, &sm.rw_full[st]);                // Y0^T hi, lo
        if (DKV) bulk_load(sm.rw[st][2], t1 + 2 * P, 2 * P * 4, &sm.rw_full[st]);  // Y1^T hi, lo
      }
      if (DKV) {  // P = ex2(s * scale * log2(e) - lse): 0 past nq
        for (int cq = lane; cq < T; cq += 32) {
          const int row = j * T + cq;
          sm.lse[st][cq] = row < nq ? fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row])) : INFINITY;
          sm.dd[st][cq] = row < nq ? dd[st0 + row] : 0.f;
        }
        mbar_arrive(&sm.rw_full[st]);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rr = warp * 16 + g, row0 = r0 + rr;  // this thread's rows: row0 and row0 + 8
  // the resident A fragments, once: each k8 step's hi + lo (exact in fp32), split again as read
#pragma unroll 1
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      uint32_t hi[4], lo[4];
      load_frags<kHalf>(op ? x1 : x0, rt0, rr, t4, cb, hi, lo);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(hi[e]) + __uint_as_float(lo[e]);
      sm.res[op][cb][tid] = make_float4(v[0], v[1], v[2], v[3]);
    }
  float lse[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};  // dQ: this thread's rows' statistics, P = 0 past nq
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse[r] = row < nq ? fmaf(m[st0 + row], kLog2e, log2f(l[st0 + row])) : INFINITY;
      drow[r] = row < nq ? dd[st0 + row] : 0.f;
    }
  }
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t ddh = sdesc(&sm.dh[0][0][0], 16, 256), drw = sdesc(&sm.rw[0][0][0], 16, 256);
  constexpr uint64_t kPl = P * 4 >> 4, kDhSlot = sizeof(sm.dh[0]) >> 4, kRwSlot = sizeof(sm.rw[0]) >> 4;
  const uint32_t x_peer = peer_addr(&sm.x[0][tid], peer), xfull_peer = peer_addr(&sm.xfull, peer),
                 xempty_peer = peer_addr(&sm.xempty, peer);

  // Partial S = X0 . Y0^T and dP = X1 . Y1^T over this CTA's 80 columns (the
  // dh slot's planes 0, 1 and 2, 3): a group per two k8 steps, both
  // products, X_lo.Y_hi + X_hi.Y_lo + X_hi.Y_hi each, accumulated on the
  // tensor cores.
  auto dh_products = [&](float (&s)[T / 2], float (&dp)[T / 2], int st) {
#pragma unroll
    for (int gq = 0; gq < NB / 2; ++gq) {
      uint32_t ah[2][8], al[2][8];
      uint64_t db[2][2][2];  // [operand][k8 step][plane: hi, lo]
#pragma unroll
      for (int op = 0; op < 2; ++op)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 a = sm.res[op][2 * gq + c][tid];
          split_tf32(a.x, ah[op][4 * c], al[op][4 * c]);
          split_tf32(a.y, ah[op][4 * c + 1], al[op][4 * c + 1]);
          split_tf32(a.z, ah[op][4 * c + 2], al[op][4 * c + 2]);
          split_tf32(a.w, ah[op][4 * c + 3], al[op][4 * c + 3]);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            db[op][c][p] = ddh + st * kDhSlot + (2 * op + p) * kPl + (2 * gq + c) * (T * 32 >> 4);
        }
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        pin(ah[op]);
        pin(al[op]);
        pin(db[op][0]);
        pin(db[op][1]);
      }
      pin(s);
      pin(dp);
      auto terms = [&](float (&d)[T / 2], const uint32_t (&h)[8], const uint32_t (&lw)[8],
                       const uint64_t (&b)[2][2]) {  // the small terms first
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (gq == 0 && c == 0) wgmma_tf32_n32_zero(d, &lw[0], b[0][0], zero);
          else wgmma_tf32_n32(d, &lw[4 * c], b[c][0], one);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) wgmma_tf32_n32(d, &h[4 * c], b[c][1], one);
#pragma unroll
        for (int c = 0; c < 2; ++c) wgmma_tf32_n32(d, &h[4 * c], b[c][0], one);
      };
      wgmma_fence();
      terms(s, ah[0], al[0], db[0]);
      terms(dp, ah[1], al[1], db[1]);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
    }
  };
  // out += X . Y over the tile's rows: X's hi and lo fragments, Y the rows
  // slot's transposed planes from y (0: Y0^T, 2: Y1^T), this CTA's 80
  // columns in NH groups of DN
  auto rows_product = [&](float (&out)[kHalf / 2], float (&acc)[DN / 2], uint32_t (&hi)[T / 2],
                          uint32_t (&lo)[T / 2], int y, int st) {
    pin(hi);
    pin(lo);
#pragma unroll
    for (int hb = 0; hb < NH; ++hb) {
      uint64_t dy[2 * KG];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          dy[p * KG + kg] = drw + st * kRwSlot + (y + p) * kPl + kg * (kHalf * 32 >> 4) + hb * (DN * 32 >> 4);
      pin(dy);
      wgmma_fence();
      rs_rows<DN, KG>(acc, hi, lo, dy, one, zero);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) out[hb * DN / 2 + i] += acc[i];
    }
  };
  // Tile j + 1's partials go to the peer (into its x, once it has read tile
  // j's) after tile j's products over the rows; the peer's come back after
  // tile j + 2's products over dh. The stores complete their bytes on the
  // peer's xfull, which the peer's thread 0 arms for each tile once the last
  // has landed (before its warp's lane 0 lets this CTA write again). Each
  // warp's lane 0 tells the peer that the warp has read its partials
  // (__syncwarp orders the reads before the release).
  auto store = [&](const float (&s)[T / 2], const float (&dp)[T / 2], int j) {
    if (j > 0) mbar_wait<true>(&sm.xempty, (j - 1) & 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      st_async_peer(x_peer + q * 128 * 16, make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]),
                    xfull_peer);
      st_async_peer(x_peer + (4 + q) * 128 * 16,
                    make_float4(dp[4 * q], dp[4 * q + 1], dp[4 * q + 2], dp[4 * q + 3]), xfull_peer);
    }
  };
  auto receive = [&](float (&s)[T / 2], float (&dp)[T / 2], int j) {  // adds the peer's partials
    mbar_wait(&sm.xfull, j & 1);
    if (tid == 0 && j + 1 < n_t) mbar_expect_tx(&sm.xfull, sizeof(sm.x));  // tile j + 1's
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 ps = sm.x[q][tid], pd = sm.x[4 + q][tid];
      s[4 * q] += ps.x;
      s[4 * q + 1] += ps.y;
      s[4 * q + 2] += ps.z;
      s[4 * q + 3] += ps.w;
      dp[4 * q] += pd.x;
      dp[4 * q + 1] += pd.y;
      dp[4 * q + 2] += pd.z;
      dp[4 * q + 3] += pd.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_peer(xempty_peer);
  };
  auto dh_tile = [&](float (&s)[T / 2], float (&dp)[T / 2], int j) {
    const int st = j % S;
    if (j < n_t) {
      mbar_wait(&sm.dh_full[st], (j / S) & 1);
      __syncwarp();
    }
    dh_products(s, dp, st);
    if (lane == 0) mbar_arrive(&sm.dh_empty[st]);
  };

  const float c = scale * kLog2e;
  const int tail = nk - (n_t - 1) * T;  // dQ: valid keys of the last tile
  float run0[kHalf / 2], run1[kHalf / 2], acc[DN / 2], s[T / 2], dp[T / 2], s2[T / 2], dp2[T / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) run0[i] = run1[i] = 0.f;
  uint32_t fhi[T / 2], flo[T / 2];

  dh_tile(s, dp, 0);
  store(s, dp, 0);
  for (int j = 0; j < n_t; ++j) {
    const int st = j % S;
    dh_tile(s2, dp2, j + 1);
    receive(s, dp, j);
    mbar_wait(&sm.rw_full[st], (j / S) & 1);
    __syncwarp();
    if constexpr (DKV) {
      // this thread's columns: queries 8jj + 2*t4 + {0, 1} of the tile
#pragma unroll
      for (int jj = 0; jj < KG; ++jj) {
        const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[st][8 * jj + 2 * t4]);
        const float2 d = *reinterpret_cast<const float2*>(&sm.dd[st][8 * jj + 2 * t4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * jj + e] = ex2(fmaf(s[4 * jj + e], c, -(e & 1 ? ls.y : ls.x)));       // P^T
          dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - (e & 1 ? d.y : d.x));  // dS^T
        }
      }
      split_frags<T>(s, fhi, flo);
      rows_product(run1, acc, fhi, flo, 2, st);  // dV += P^T . dO
      split_frags<T>(dp, fhi, flo);
      rows_product(run0, acc, fhi, flo, 0, st);  // dK += dS^T . Q
    } else {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) s[i] = ex2(fmaf(s[i], c, -lse[(i >> 1) & 1]));  // P
      if (j == n_t - 1 && tail < T) {  // keys past nk
#pragma unroll
        for (int i = 0; i < T / 2; ++i)
          if (8 * (i >> 2) + 2 * t4 + (i & 1) >= tail) s[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < T / 2; ++i) s[i] *= dp[i] - drow[(i >> 1) & 1];  // dS
      split_frags<T>(s, fhi, flo);
      rows_product(run0, acc, fhi, flo, 0, st);  // dQ += dS . K
    }
    if (lane == 0) mbar_arrive(&sm.rw_empty[st]);
    if (j + 1 < n_t) store(s2, dp2, j + 1);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      s[i] = s2[i];
      dp[i] = dp2[i];
    }
  }
  mbar_wait<true>(&sm.xempty, (n_t - 1) & 1);  // the peer has read our last partials: nothing more comes in
  const long long cols = (long long)heads * 2 * kHalf;
  const long long base = (long long)b * (DKV ? nk : nq) * cols + h * 2 * kHalf + rank * kHalf;
  store_rows<kHalf>(out0, run0, scale, base, cols, row0, DKV ? nk : nq, t4);  // dQ or dK
  if constexpr (DKV) {
    store_rows<kHalf>(out1, run1, 1.f, base, cols, row0, nk, t4);  // dV
    grid_dependency_wait();  // the dQ kernel before it on the stream is done
  }
}

// ---- host side

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *dd;
  void *dq, *dk, *dv, *planes;
  int b, nq, nk, heads;
  float scale;
};

// the planes of Q, K, V and dO, one after the other, each [b * heads][tiles][4][T * DH]
template <int DH>
void plane_ptrs(const Args& a, float*& pq, float*& pk, float*& pv, float*& pdo) {
  constexpr long long tile = 4LL * kT<DH> * DH;
  const long long bh = (long long)a.b * a.heads;
  pq = static_cast<float*>(a.planes);
  pk = pq + bh * tiles<DH>(a.nq) * tile;
  pv = pk + bh * tiles<DH>(a.nk) * tile;
  pdo = pv + bh * tiles<DH>(a.nk) * tile;
}

template <int DH>
int split(const Args& a, cudaStream_t stream) {
  float *pq, *pk, *pv, *pdo;
  plane_ptrs<DH>(a, pq, pk, pv, pdo);
  // dh 160: two heads of 80 columns each, the cluster kernel's CTAs' halves
  constexpr int DS = DH > 80 ? kHalf : DH, hs = DH / DS;
  const int bh = a.b * a.heads * hs, heads = a.heads * hs;
  split_planes_kernel<DS><<<dim3(tiles<DS>(a.nq), bh), 256, 0, stream>>>(static_cast<const float*>(a.q), pq, a.nq, heads);
  split_planes_kernel<DS><<<dim3(tiles<DS>(a.nk), bh), 256, 0, stream>>>(static_cast<const float*>(a.k), pk, a.nk, heads);
  split_planes_kernel<DS><<<dim3(tiles<DS>(a.nk), bh), 256, 0, stream>>>(static_cast<const float*>(a.v), pv, a.nk, heads);
  split_planes_kernel<DS><<<dim3(tiles<DS>(a.nq), bh), 256, 0, stream>>>(static_cast<const float*>(a.dout), pdo, a.nq,
                                                                        heads);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool DKV>
int launch(const Args& a, cudaStream_t stream) {
  float *pq, *pk, *pv, *pdo;
  plane_ptrs<DH>(a, pq, pk, pv, pdo);
  const int n_res = DKV ? a.nk : a.nq;
  if constexpr (DH > 80) {  // the cluster kernel: two CTAs per 64 resident rows
    constexpr int smem = ClusterCfg<DKV>::kSmemBytes;
    static const cudaError_t attr =
        cudaFuncSetAttribute(bwd_f32_cluster_kernel<DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * ((n_res + kRes - 1) / kRes), a.b * a.heads);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = 2;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // dK/dV may overlap the dQ kernel's tail
    attrs[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = DKV ? 2 : 1;
    const cudaError_t err =
        DKV ? cudaLaunchKernelEx(&cfg, bwd_f32_cluster_kernel<DKV>, (const float*)pk, (const float*)pv,
                                 (const float*)pq, (const float*)pdo, a.m, a.l, a.dd, static_cast<float*>(a.dk),
                                 static_cast<float*>(a.dv), a.nq, a.nk, a.heads, a.scale)
            : cudaLaunchKernelEx(&cfg, bwd_f32_cluster_kernel<DKV>, (const float*)pq, (const float*)pdo,
                                 (const float*)pk, (const float*)pv, a.m, a.l, a.dd, static_cast<float*>(a.dq),
                                 static_cast<float*>(nullptr), a.nq, a.nk, a.heads, a.scale);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  } else {
    const dim3 grid((n_res + kRes - 1) / kRes, a.b * a.heads);
    auto run = [&](auto kernel, int smem) {
      static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return attr;
      if constexpr (DKV)
        kernel<<<grid, kThreads, smem, stream>>>(pk, pv, pq, pdo, a.m, a.l, a.dd, static_cast<float*>(a.dk),
                                                 static_cast<float*>(a.dv), a.nq, a.nk, a.heads, a.scale);
      else
        kernel<<<grid, kThreads, smem, stream>>>(pq, pdo, pk, pv, a.m, a.l, a.dd, static_cast<float*>(a.dq), a.nq,
                                                 a.nk, a.heads, a.scale);
      return cudaSuccess;
    };
    cudaError_t err;
    if constexpr (DKV) err = run(bwd_dkv_f32_kernel<DH>, Cfg<DH, true>::kSmemBytes);
    else err = run(bwd_dq_f32_kernel<DH>, Cfg<DH, false>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// what: 0 the split pass, 1 dQ, 2 dK/dV
int dispatch(const Args& a, int dh, int what, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nq < 1 || a.nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = bind_device(a.planes); err != cudaSuccess) return static_cast<int>(err);
  auto run = [&](auto tag) {
    constexpr int DH = decltype(tag)::value;
    return what == 0 ? split<DH>(a, st) : what == 1 ? launch<DH, false>(a, st) : launch<DH, true>(a, st);
  };
  switch (dh) {
    case 16: return run(std::integral_constant<int, 16>{});
    case 32: return run(std::integral_constant<int, 32>{});
    case 40: return run(std::integral_constant<int, 40>{});
    case 80: return run(std::integral_constant<int, 80>{});
    case 160: return run(std::integral_constant<int, 160>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: (b, nq, heads * dh); k, v: (b, nk, heads * dh); fp32, contiguous,
// 16-byte aligned; m, l, dd: (b * heads, nq) fp32 (m and l from K7's fp32
// form, dd = rowsum(dO * O) per head and row); dh one of 16, 32, 40, 80, 160;
// planes: the split pass's scratch, 4 * b * heads * dh * 64 * (2 * ceil(nq /
// 64) + 2 * ceil(nk / 64)) fp32 values. Each returns cudaGetLastError() after
// its launches (cudaErrorInvalidValue, 1, for a width that is not built).

// The split pass: Q's, K's, V's and dO's tf32 planes into `planes`.
extern "C" int vface_flash_attention_bwd_split_f32(const void* q, const void* k, const void* v, const void* dout,
                                                   void* planes, int b, int nq, int nk, int heads, int dh,
                                                   void* stream) {
  const Args a{q, k, v, dout, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, planes, b, nq, nk, heads, 0.f};
  return dispatch(a, dh, 0, stream);
}

// K5 on fp32, dQ: (b, nq, heads * dh) fp32, from the split pass's planes.
extern "C" int vface_flash_attention_bwd_dq_f32(const void* planes, const void* m, const void* l, const void* dd,
                                                void* dq, int b, int nq, int nk, int heads, int dh, float scale,
                                                void* stream) {
  const Args a{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const float*>(dd), dq, nullptr, nullptr, const_cast<void*>(planes), b, nq, nk, heads, scale};
  return dispatch(a, dh, 1, stream);
}

// K5 on fp32, dK and dV: (b, nk, heads * dh) fp32 each, from the split pass's planes.
extern "C" int vface_flash_attention_bwd_dkv_f32(const void* planes, const void* m, const void* l, const void* dd,
                                                 void* dk, void* dv, int b, int nq, int nk, int heads, int dh,
                                                 float scale, void* stream) {
  const Args a{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const float*>(dd), nullptr, dk, dv, const_cast<void*>(planes), b, nq, nk, heads, scale};
  return dispatch(a, dh, 2, stream);
}

// Dynamic shared memory of the dQ (dkv 0) or dK/dV (dkv 1) kernel at head width dh, in bytes (0 if not built).
extern "C" int vface_flash_attention_bwd_f32_smem_bytes(int dh, int dkv) {
  switch (dh) {
    case 16: return dkv ? Cfg<16, true>::kSmemBytes : Cfg<16, false>::kSmemBytes;
    case 32: return dkv ? Cfg<32, true>::kSmemBytes : Cfg<32, false>::kSmemBytes;
    case 40: return dkv ? Cfg<40, true>::kSmemBytes : Cfg<40, false>::kSmemBytes;
    case 80: return dkv ? Cfg<80, true>::kSmemBytes : Cfg<80, false>::kSmemBytes;
    case 160: return dkv ? ClusterCfg<true>::kSmemBytes : ClusterCfg<false>::kSmemBytes;
    default: return 0;
  }
}
