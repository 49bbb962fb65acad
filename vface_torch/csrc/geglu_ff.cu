// GEGLU feed-forward for Hopper (sm_90a): K2, K9 and K13 on bf16, K2 and K9 on fp32.
//
// Replaces vface_tpu/ops/pallas_ff.py::geglu_ff (_ff_kernel via _pallas_impl,
// K2), pallas_ff.py::_pallas_impl_wide (_ff_kernel_wide, K9) and
// scripts/bench_ff_tile.py::_pallas_split (_ff_kernel_split, K13). All three
// compute
//
//   gate = bf16(x @ Wg) + bg          (a bf16 add after the bf16 round)
//   g    = bf16(gelu_erf(f32(gate)))
//   a    = bf16(x @ Wa) + ba
//   out  = bf16((a * g) @ Wo) + bo    (fp32 sums over the whole inner dim)
//
// with Wa = proj rows [0, I), Wg = proj rows [I, 2I) in PyTorch's Linear
// layout (proj: (2I, C), proj_out: (C, I)): every operand is K-major, as
// wgmma reads it.
//
// What bounds it on the H100: 6*M*C*I FLOPs on the tensor cores (0.12 ms at
// the UNet's ds1, ds2 and ds4 sites at b = 12) against bytes of x, weights and
// out that take a tenth of that, so the products set the pace if the weights
// reach the SMs fast enough. A kernel that keeps the (M, I) intermediate on
// chip streams all the weights (3*C*I bf16) through L2 once per row tile: the
// previous design (mma.sync on 32-row tiles, weights read by every warp from
// L2) moved 3.8 GB per call at ds1 and ran at L2's pace, 11x its bound.
//
// The fused kernel (K2 and K13 at C = 64 and 320). One CTA owns 64 * RW
// rows: the x tile is loaded once by TMA, and the weights stream through two
// slots each of the inner chunks' [Wa | Wg] rows (the first product's B
// operand, NI rows of each) and Wo columns (the second's), each slot
// completed on an mbarrier. Consumer warpgroups, one per 64 rows, run both
// products on wgmma with fp32 accumulators. At C = 320, 128 rows per CTA
// (RW = 2) cut the weight traffic to 0.94 GB per call at ds1. A warpgroup
// holds its 64 x 320 output in 160 fp32 registers, so the chunk is narrow:
// NI = 32 inner columns, one m64n64 product [a | gate] (32 registers) per k16
// step of x.
// The chunk's epilogue (bias adds, erf-GELU in fp32, a*g rounded to bf16)
// writes a*g to shared memory, where it is the A operand of the second
// product. The (M, I) intermediate never reaches device memory.
// Registers set the shape: a consumer needs ~248 of them, and four warps
// share each quarter of the register file, so a separate producer warp would
// cap every thread at 168 (the consumers spilled so, with setmaxnreg raising
// them to 240 and with a producer warp alike). Thread 0 issues the loads
// instead, once per chunk, after a named barrier over all consumers says that
// chunk ch's [Wa | Wg] slot and chunk ch-1's Wo slot are free: [Wa | Wg] of
// chunk ch + 2 and Wo of ch + 1 then load while two chunks compute.
//
// The two-kernel form (K9 at C = 1024 and 1280, K2 and K13 at C = 640, where
// it beat a fused form that split the output columns over two warpgroups). A
// fused kernel cannot hold a 64 x 1280 fp32 output in a CTA (320 KB), as the TPU's
// fused wide kernel lost to XLA for its VMEM (pallas_ff.py:130-137). Two GEMM
// kernels on the same wgmma + TMA ring: GEMM 1 computes the gate and A
// products of a 128 x 128 tile of inner columns and stores h = bf16(a * g);
// GEMM 2 computes out = bf16(h @ Wo^T) + bo with fp32 sums over all of I, one
// rounding. h is the bf16 value the fused kernels feed to their second
// product, so the function is K2's to the summation order. The wrapper
// allocates h (M x I bf16: 31 MB at ds4, b = 12); the kernels allocate nothing.
//
// fp32 (K2 at C 64/320/640, K9 at 1024/1280; JAX's kernels round at x's dtype,
// which at fp32 rounds nothing): h = (x @ Wa^T + ba) * gelu_erf(x @ Wg^T + bg)
// and out = h @ Wo^T + bo, all in fp32. fp32-accurate products on the tensor
// cores are three tf32 terms of hi = tf32(v), lo = tf32(v - hi) splits,
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (3xTF32, as flash_attention_f32.cu): 6*M*C*I
// FLOPs at a third of the tf32 peak, 165 TFLOP/s against the CUDA cores' 67.
// The same two-kernel form on tf32 wgmma: a split pass writes the weights' hi
// and lo planes once per call (bytes small beside M*C*I); each GEMM stage holds
// a 128-row x 32-column block of A (x, then h) and the B planes' 64-row
// blocks, all K-major in the 128-byte swizzle; each consumer reads its A
// fragments from shared memory and splits them in registers, so A needs no
// planes. GEMM 1 keeps the a and gate accumulators of 64 inner columns, GEMM 2
// one of 64 output columns. Each 32-column block's three-term product goes to
// a fresh accumulator that the CUDA cores add to the running sum (fp32, round
// to nearest): the tensor cores' own fp32 sums do not round to nearest, and
// GEMM 2 sums over up to 5,120 columns. h (M x I fp32) and the planes are
// scratch tensors the wrapper allocates.
//
// Layouts: x, Wa/Wg and the GEMMs' operands land by TMA as 64-column boxes in
// the 128-byte swizzle ([64-column block][row][64]); the fused kernels' Wo
// chunk and a*g buffer are 16-column blocks in the 32-byte swizzle
// ([16-column block][row][16]), the layout of flash_attention.cu. Every
// operand register of a wgmma group (descriptors, the accumulate flag, the
// accumulators) is defined before the group's wgmma.fence and pinned there:
// ptxas serializes every wgmma of a kernel otherwise (warnings C7513 for an
// input, C7515 for an accumulator; the zeroed output accumulators are pinned
// at once, or their zeroing drifts into the first product's groups). Rows
// past M read as zeros (TMA) and are not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use (H100)
constexpr int kBlk = 64;          // columns per 128-byte swizzle row: a k64 block
constexpr int kGemmN = 128;       // output columns of a GEMM tile
// The GEMMs' two consumer warpgroups take a producer warpgroup that gives its
// registers to them (setmaxnreg): the CTA launches at 168 a thread (384
// threads; a quarter of the register file holds 3 warps) and the pool stays
// whole, 24 + 2 * 240 = 3 * 168.
constexpr int kGemmThreads = 384, kConsumerRegs = 240, kProducerRegs = 24;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// bf16(acc) + bias as a bf16 add: exact in fp32, one rounding to bf16
__device__ __forceinline__ float bf16_add(float acc, __nv_bfloat16 bias) {
  return bf16_round(bf16_round(acc) + __bfloat162float(bias));
}

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f)); }

// a*g for one pair of columns: a and gate accumulators, their biases
__device__ __forceinline__ __nv_bfloat162 geglu_pair(float a0, float a1, float g0, float g1, __nv_bfloat16 ba0,
                                                     __nv_bfloat16 ba1, __nv_bfloat16 bg0, __nv_bfloat16 bg1) {
  const float ga = bf16_round(gelu_erf(bf16_add(g0, bg0))), gb = bf16_round(gelu_erf(bf16_add(g1, bg1)));
  return __floats2bfloat162_rn(bf16_add(a0, ba0) * ga, bf16_add(a1, ba1) * gb);
}

// d (+)= A . B^T, m64nNk16, both operands K-major in shared memory
template <int N, bool ZERO>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, uint32_t flag) {
  if constexpr (N == 16) ZERO ? wgmma_ss_n16_zero(d, da, db, flag) : wgmma_ss_n16(d, da, db, flag);
  else if constexpr (N == 64) ZERO ? wgmma_ss_n64_zero(d, da, db, flag) : wgmma_ss_n64(d, da, db, flag);
  else if constexpr (N == 128) wgmma_ss_n128(d, da, db, flag);
  else wgmma_ss_n160(d, da, db, flag);
}

// ---------------------------------------------------------------- fused kernel

// C output columns, RW warpgroups of 64 rows, NI inner columns per chunk. Two
// slots each for the chunks' [Wa | Wg] rows and Wo columns.
template <int C, int RW, int NI>
struct Fused {
  static constexpr int kRows = 64 * RW;
  static constexpr int kThreads = 128 * RW;
  static constexpr int kSW = 2 * NI;  // the first product's columns: NI a then NI gate
  static constexpr int kOB = C % 160 == 0 ? 160 : 64;  // columns per wgmma of the second product
  static constexpr int kHB = NI / kAtom;   // k16 steps of the second product
  static constexpr int kWoBox = C <= 256 ? C : 160;  // TMA boxes hold at most 256 rows
  static_assert(C % kBlk == 0 && C % kOB == 0 && NI % kAtom == 0, "unsupported tile");

  struct Smem {
    __nv_bfloat16 x[C / kBlk][kRows][kBlk];
    __nv_bfloat16 wpg[2][C / kBlk][2 * NI][kBlk];  // the chunk's a rows, then its gate rows
    __nv_bfloat16 wo[2][kHB][C][kAtom];
    __nv_bfloat16 h[RW][2][kHB][64][kAtom];  // a*g, double-buffered per row warpgroup
    uint64_t x_full, wpg_full[2], wo_full[2];
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the slack to align it to 1024 bytes
};

template <int C, int RW, int NI>
__global__ void __launch_bounds__(Fused<C, RW, NI>::kThreads, 1)
geglu_fused_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap twp,
                   const __grid_constant__ CUtensorMap two, const __nv_bfloat16* __restrict__ bp,
                   const __nv_bfloat16* __restrict__ bo, __nv_bfloat16* __restrict__ out, int m, int inner) {
  using F = Fused<C, RW, NI>;
  constexpr int SW = F::kSW, OB = F::kOB, NOB = C / OB, HB = F::kHB, KB = C / kBlk;
  extern __shared__ uint8_t smem_raw[];
  typename F::Smem& sm =
      *reinterpret_cast<typename F::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * F::kRows;
  const int n_ch = inner / NI;

  // Thread 0 issues every load. Chunk ch's [Wa | Wg] rows go to slot ch & 1
  // and are reloaded (chunk ch + 2) once every warpgroup's first product of
  // ch is done; its Wo columns too, reloaded (chunk ch + 2) once every second
  // product of ch is done. Each slot's mbarrier completes once per load.
  auto load_wpg = [&](int ch) {
    const int sl = ch & 1;
    mbar_expect_tx(&sm.wpg_full[sl], sizeof(sm.wpg[0]));
    for (int kb = 0; kb < KB; ++kb) {
      tma_load(&sm.wpg[sl][kb][0][0], &twp, &sm.wpg_full[sl], kb * kBlk, ch * NI, 0);
      tma_load(&sm.wpg[sl][kb][NI][0], &twp, &sm.wpg_full[sl], kb * kBlk, inner + ch * NI, 0);
    }
  };
  auto load_wo = [&](int ch) {
    const int sl = ch & 1;
    mbar_expect_tx(&sm.wo_full[sl], sizeof(sm.wo[0]));
    for (int hb = 0; hb < HB; ++hb)
      for (int r = 0; r < C; r += F::kWoBox)
        tma_load(&sm.wo[sl][hb][r][0], &two, &sm.wo_full[sl], ch * NI + hb * kAtom, r, 0);
  };
  if (tid == 0) {
    mbar_init(&sm.x_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.wpg_full[s], 1);
      mbar_init(&sm.wo_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&sm.x_full, sizeof(sm.x));
    for (int kb = 0; kb < KB; ++kb) tma_load(&sm.x[kb][0][0], &tx, &sm.x_full, kb * kBlk, row0, 0);
    load_wpg(0);
    if (n_ch > 1) load_wpg(1);
    load_wo(0);
    if (n_ch > 1) load_wo(1);
  }
  __syncthreads();

  const int rw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));

  // Descriptors in 16-byte units. First product: x's k16 step ks is 64-column
  // block ks/4 (kRows rows of 128 bytes) plus 32 bytes per step inside it;
  // the chunk's [Wa | Wg] tile the same with 2*NI rows. Second product: a*g's
  // and Wo's k16 steps are their 16-column blocks.
  const uint64_t dx0 = sdesc128(&sm.x[0][rw * 64][0]);
  const uint64_t dw0 = sdesc128(&sm.wpg[0][0][0][0]);
  const uint64_t dh0 = sdesc(&sm.h[rw][0][0][0][0], 16, 256);
  const uint64_t do0 = sdesc(&sm.wo[0][0][0][0], 16, 256);
  constexpr uint64_t kXBlk = F::kRows * kBlk * 2 >> 4, kWBlk = 2 * NI * kBlk * 2 >> 4;
  constexpr uint64_t kWSlot = sizeof(sm.wpg[0]) >> 4, kOSlot = sizeof(sm.wo[0]) >> 4;
  constexpr uint64_t kHBuf = sizeof(sm.h[0][0]) >> 4, kHBlk = 64 * kAtom * 2 >> 4, kOBlk = C * kAtom * 2 >> 4;

  float o[NOB][OB / 2], s[SW / 2];
#pragma unroll
  for (int nb = 0; nb < NOB; ++nb) {
#pragma unroll
    for (int i = 0; i < OB / 2; ++i) o[nb][i] = 0.f;
    pin(o[nb]);  // zeroed here, not inside the first product's wgmma groups (C7515)
  }

  mbar_wait(&sm.x_full, 0);
  for (int ch = 0; ch < n_ch; ++ch) {
    const int sl = ch & 1;
    const uint32_t par = (ch >> 1) & 1;
    // ---- s = x . [Wa | Wg](ch)^T, one wgmma group per 64-column block of x
    mbar_wait(&sm.wpg_full[sl], par);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint64_t da[4], db[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk] = dx0 + kb * kXBlk + 2 * kk;
        db[kk] = dw0 + sl * kWSlot + kb * kWBlk + 2 * kk;
      }
      pin(da);
      pin(db);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kb == 0 && kk == 0) wgmma_ss<SW, true>(s, da[0], db[0], zero);
        else wgmma_ss<SW, false>(s, da[kk], db[kk], one);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();  // s, and the second product of chunk ch-1
    pin(s);
    // every warpgroup is done with [Wa | Wg](ch) and Wo(ch-1): reload both slots
    bar_sync(1, F::kThreads);
    if (tid == 0) {
      if (ch + 2 < n_ch) load_wpg(ch + 2);
      if (ch >= 1 && ch + 1 < n_ch) load_wo(ch + 1);
    }

    // ---- epilogue: bias adds, erf-GELU, a*g in bf16 into the 32-byte swizzle
    // of this warpgroup's buffer; s holds a in columns [0, NI) and the gate in
    // [NI, 2*NI) of the m64nSW accumulator layout
    const int ic0 = ch * NI;  // the chunk's first inner column
    __nv_bfloat16* hbuf = &sm.h[rw][ch & 1][0][0][0];
#pragma unroll
    for (int j = 0; j < SW / 16; ++j) {
      const int hc = 8 * j + 2 * t4;  // column of the chunk's a*g
      const __nv_bfloat16 ba0 = bp[ic0 + hc], ba1 = bp[ic0 + hc + 1];
      const __nv_bfloat16 bg0 = bp[inner + ic0 + hc], bg1 = bp[inner + ic0 + hc + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        const int jg = j + SW / 16;
        *reinterpret_cast<__nv_bfloat162*>(hbuf + ((hc >> 4) * 64 + row) * kAtom +
                                           8 * (((hc & 15) >> 3) ^ ((row >> 2) & 1)) + (hc & 7)) =
            geglu_pair(s[4 * j + 2 * r], s[4 * j + 2 * r + 1], s[4 * jg + 2 * r], s[4 * jg + 2 * r + 1], ba0,
                       ba1, bg0, bg1);
      }
    }
    fence_proxy_async();
    bar_sync(2 + rw, 128);  // the chunk's whole a*g is in place

    // ---- o += (a*g)(ch) . Wo(ch)^T, one wgmma group: o is pinned once, before its fence (pins between groups in
    // flight would serialize every wgmma, ptxas warning C7515)
    mbar_wait(&sm.wo_full[sl], par);
    uint64_t da[HB], db[HB * NOB];
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) {
      da[hb] = dh0 + (ch & 1) * kHBuf + hb * kHBlk;
#pragma unroll
      for (int nb = 0; nb < NOB; ++nb)
        db[hb * NOB + nb] = do0 + sl * kOSlot + hb * kOBlk + nb * (OB * kAtom * 2 >> 4);
    }
    pin(da);
    pin(db);
#pragma unroll
    for (int nb = 0; nb < NOB; ++nb) pin(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int hb = 0; hb < HB; ++hb)
#pragma unroll
      for (int nb = 0; nb < NOB; ++nb) wgmma_ss<OB, false>(o[nb], da[hb], db[hb * NOB + nb], one);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NOB; ++nb) pin(o[nb]);

  // ---- out = bf16(o) + bo, a bf16 add
#pragma unroll
  for (int nb = 0; nb < NOB; ++nb)
#pragma unroll
    for (int j = 0; j < OB / 8; ++j) {
      const int col = nb * OB + 8 * j + 2 * t4;
      const __nv_bfloat16 b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + rw * 64 + warp * 16 + g + 8 * r;
        if (row < m)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * C + col) =
              __floats2bfloat162_rn(bf16_add(o[nb][4 * j + 2 * r], b0), bf16_add(o[nb][4 * j + 2 * r + 1], b1));
      }
    }
}

// ---------------------------------------------------------------- GEMM kernels

// GEGLU: h (m, inner) = bf16(a*g) from x (m, k = C) and w_proj's Wa, Wg rows.
// !GEGLU: out (m, n) = bf16(a @ w^T) + bias for a (m, k) and w (n, k).
template <bool GEGLU>
struct Gemm {
  static constexpr int kRows = 128;
  static constexpr int kNB = GEGLU ? 2 : 1;  // m64n128 accumulators: a and gate, or out
  static constexpr int kStage = (kRows + kNB * kGemmN) * kBlk * 2;
  static constexpr int kStages = (kSmemMax - 2048) / kStage < 8 ? (kSmemMax - 2048) / kStage : 8;
  struct Smem {
    __nv_bfloat16 a[kStages][kRows][kBlk];
    __nv_bfloat16 b[kStages][kNB * kGemmN][kBlk];
    uint64_t full[kStages], empty[kStages];
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;
};

// ta: (m, k) in boxes of 64 x 128; tb: (rows, k) in boxes of 64 x 128;
// bias: GEGLU w_proj's bias (2*inner), else (n,); dst (m, n) with n = inner
// for GEGLU. The tile at (blockIdx.x, blockIdx.y) is rows 128*x, columns
// 128*y.
template <bool GEGLU>
__global__ void __launch_bounds__(kGemmThreads, 1)
geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ dst, int m, int n, int k) {
  using G = Gemm<GEGLU>;
  constexpr int ST = G::kStages, NB = G::kNB;
  extern __shared__ uint8_t smem_raw[];
  typename G::Smem& sm =
      *reinterpret_cast<typename G::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * G::kRows, n0 = blockIdx.y * kGemmN;
  const int kt_n = k / kBlk;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int st = kt % ST;
        mbar_wait(&sm.empty[st], ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], sizeof(sm.a[0]) + sizeof(sm.b[0]));
        tma_load(&sm.a[st][0][0], &ta, &sm.full[st], kt * kBlk, row0, 0);
        tma_load(&sm.b[st][0][0], &tb, &sm.full[st], kt * kBlk, n0, 0);
        if (GEGLU) tma_load(&sm.b[st][kGemmN][0], &tb, &sm.full[st], kt * kBlk, n + n0, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t one = 1;
  asm volatile("" : "+r"(one));
  const uint64_t da0 = sdesc128(&sm.a[0][wg * 64][0]);
  const uint64_t db0 = sdesc128(&sm.b[0][0][0]);
  constexpr uint64_t kAStage = sizeof(sm.a[0]) >> 4, kBStage = sizeof(sm.b[0]) >> 4;
  constexpr uint64_t kBHalf = kGemmN * kBlk * 2 >> 4;

  float acc[NB][64];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;

  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % ST;
    mbar_wait(&sm.full[st], (kt / ST) & 1);
    uint64_t da[4], db[NB * 4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      da[kk] = da0 + st * kAStage + 2 * kk;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) db[nb * 4 + kk] = db0 + st * kBStage + nb * kBHalf + 2 * kk;
    }
    pin(da);
    pin(db);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wgmma_ss<kGemmN, false>(acc[nb], da[kk], db[nb * 4 + kk], one);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group is done: release it
    if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[(kt - 1) % ST]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    __nv_bfloat16 b[4] = {bias[col], bias[col + 1]};
    if (GEGLU) b[2] = bias[n + col], b[3] = bias[n + col + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row >= m) continue;
      const float* a = &acc[0][4 * j + 2 * r];
      __nv_bfloat162 v;
      if constexpr (GEGLU) {
        const float* gt = &acc[NB - 1][4 * j + 2 * r];
        v = geglu_pair(a[0], a[1], gt[0], gt[1], b[0], b[1], b[2], b[3]);
      } else {
        v = __floats2bfloat162_rn(bf16_add(a[0], b[0]), bf16_add(a[1], b[1]));
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * n + col) = v;
    }
  }
}

// ---------------------------------------------------------------- fp32: 3xTF32 GEMMs

constexpr int kTBlk = 32;  // fp32 columns per 128-byte swizzle row: a k32 block, 4 k8 steps
constexpr int kTN = 64;    // output columns of each m64n64 accumulator

// The split pass: n values of w (n a multiple of 4) as tf32 hi = tf32(w) and
// lo = tf32(w - hi), written to hi[0, n) and lo[0, n)
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float4* __restrict__ w, float4* __restrict__ hi, float4* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += (long long)gridDim.x * 256) {
    const float4 x = w[i];
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// GEGLU: h (m, inner) = (a + ba) * gelu_erf(gate + bg) in fp32 from x (m, k = C)
// and w_proj's planes (rows [0, inner) Wa, [inner, 2 inner) Wg).
// !GEGLU: out (m, n) = a @ w^T + bias for a (m, k) and w's planes (n, k).
template <bool GEGLU>
struct GemmF32 {
  static constexpr int kRows = 128;          // two consumer warpgroups of 64 rows
  static constexpr int kNB = GEGLU ? 2 : 1;  // m64n64 accumulators: a and gate, or out
  static constexpr int kBRows = kNB * kTN;
  static constexpr int kStage = (kRows + 2 * kBRows) * kTBlk * 4;  // A, B_hi, B_lo
  static constexpr int kStages = (kSmemMax - 2048) / kStage < 8 ? (kSmemMax - 2048) / kStage : 8;
  struct Smem {
    float a[kStages][kRows][kTBlk];
    float bhi[kStages][kBRows][kTBlk];
    float blo[kStages][kBRows][kTBlk];
    uint64_t full[kStages], empty[kStages];
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;
};

// ta: A (m, k) fp32 in boxes of 32 columns x 128 rows; tbh, tbl: B's tf32 hi
// and lo planes (rows, k) in boxes of 32 x 64; all in the 128-byte swizzle.
// The tile at (blockIdx.x, blockIdx.y) is output (GEGLU: inner) columns 64*x
// of rows 128*y; bias: GEGLU w_proj's (2*inner), else (n,).
template <bool GEGLU>
__global__ void __launch_bounds__(kGemmThreads, 1)
geglu_gemm_f32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tbh,
                      const __grid_constant__ CUtensorMap tbl, const float* __restrict__ bias,
                      float* __restrict__ dst, int m, int n, int k) {
  using G = GemmF32<GEGLU>;
  constexpr int ST = G::kStages, NB = G::kNB;
  extern __shared__ uint8_t smem_raw[];
  typename G::Smem& sm =
      *reinterpret_cast<typename G::Smem*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTN, row0 = blockIdx.y * G::kRows;
  const int kt_n = k / kTBlk;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int st = kt % ST;
        mbar_wait(&sm.empty[st], ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], sizeof(sm.a[0]) + sizeof(sm.bhi[0]) + sizeof(sm.blo[0]));
        tma_load(&sm.a[st][0][0], &ta, &sm.full[st], kt * kTBlk, row0, 0);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {  // GEGLU: Wa's rows, then Wg's
          const int r = nb * (GEGLU ? n : kTN) + n0;
          tma_load(&sm.bhi[st][nb * kTN][0], &tbh, &sm.full[st], kt * kTBlk, r, 0);
          tma_load(&sm.blo[st][nb * kTN][0], &tbl, &sm.full[st], kt * kTBlk, r, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t dbh0 = sdesc128(&sm.bhi[0][0][0]), dbl0 = sdesc128(&sm.blo[0][0][0]);
  constexpr uint64_t kBStage = sizeof(sm.bhi[0]) >> 4, kBHalf = kTN * kTBlk * 4 >> 4;

  // run: the output summed over the k32 blocks on the CUDA cores (fp32, round
  // to nearest); acc: one block's product on the tensor cores, whose fp32
  // sums do not round to nearest (summed over a whole row of keys in the fp32
  // attention, flash_attention_f32.cu, they drifted past 1e-5 of its peak)
  float run[NB][32], acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) run[nb][i] = 0.f;
  uint32_t ahi[16], alo[16];
  uint64_t dbh[NB * 4], dbl[NB * 4];

  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % ST;
    mbar_wait(&sm.full[st], (kt / ST) & 1);
    __syncwarp();
    // A's hi and lo fragments of the block's 4 k8 steps, split in registers:
    // rows g and g + 8 of the warp, columns 8ks + t4 and + 4, read through the
    // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7))
    const float* at = &sm.a[st][wg * 64 + warp * 16][0];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1), c = 8 * ks + t4 + 4 * (e >> 1);
        split_tf32(at[r * kTBlk + (((c >> 2) ^ (r & 7)) << 2) + (c & 3)], ahi[4 * ks + e], alo[4 * ks + e]);
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        dbh[nb * 4 + ks] = dbh0 + st * kBStage + nb * kBHalf + 2 * ks;
        dbl[nb * 4 + ks] = dbl0 + st * kBStage + nb * kBHalf + 2 * ks;
      }
    pin(ahi);
    pin(alo);
    pin(dbh);
    pin(dbl);
    // acc = A_lo.B_hi + A_hi.B_lo + A_hi.B_hi, the small terms first
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks == 0) wgmma_tf32_n64_zero(acc[nb], &alo[0], dbh[nb * 4], zero);
        else wgmma_tf32_n64(acc[nb], &alo[4 * ks], dbh[nb * 4 + ks], one);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_tf32_n64(acc[nb], &ahi[4 * ks], dbl[nb * 4 + ks], one);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_tf32_n64(acc[nb], &ahi[4 * ks], dbh[nb * 4 + ks], one);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) run[nb][i] += acc[nb][i];
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    float b[4] = {bias[col], bias[col + 1]};
    if (GEGLU) b[2] = bias[n + col], b[3] = bias[n + col + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row >= m) continue;
      const float* a = &run[0][4 * j + 2 * r];
      float2 v;
      if constexpr (GEGLU) {
        const float* gt = &run[NB - 1][4 * j + 2 * r];
        v = make_float2((a[0] + b[0]) * gelu_erf(gt[0] + b[2]), (a[1] + b[1]) * gelu_erf(gt[1] + b[3]));
      } else {
        v = make_float2(a[0] + b[0], a[1] + b[1]);
      }
      *reinterpret_cast<float2*>(dst + (long long)row * n + col) = v;
    }
  }
}

// ---------------------------------------------------------------- host side

template <class K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int C, int RW, int NI>
int launch_fused(const void* x, const void* wp, const void* bp, const void* wo, const void* bo, void* out, int m,
                 int inner, cudaStream_t stream) {
  using F = Fused<C, RW, NI>;
  if (const cudaError_t err = bind_device(x); err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx, twp, two;
  if (inner % NI != 0 || !tensor_map(&tx, x, 1, m, C, F::kRows, kBlk, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&twp, wp, 1, 2 * inner, C, NI, kBlk, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&two, wo, 1, C, inner, F::kWoBox))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = set_smem(geglu_fused_kernel<C, RW, NI>, F::kSmemBytes);
  if (attr != 0) return attr;
  geglu_fused_kernel<C, RW, NI><<<(m + F::kRows - 1) / F::kRows, F::kThreads, F::kSmemBytes, stream>>>(
      tx, twp, two, static_cast<const __nv_bfloat16*>(bp), static_cast<const __nv_bfloat16*>(bo),
      static_cast<__nv_bfloat16*>(out), m, inner);
  return static_cast<int>(cudaGetLastError());
}

template <bool GEGLU>
int launch_gemm(const void* a, const void* w, const void* bias, void* dst, int m, int n, int k, int w_rows,
                cudaStream_t stream) {
  using G = Gemm<GEGLU>;
  if (const cudaError_t err = bind_device(a); err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, 1, m, k, G::kRows, kBlk, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tb, w, 1, w_rows, k, kGemmN, kBlk, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = set_smem(geglu_gemm_kernel<GEGLU>, G::kSmemBytes);
  if (attr != 0) return attr;
  const dim3 grid((m + G::kRows - 1) / G::kRows, n / kGemmN);
  geglu_gemm_kernel<GEGLU><<<grid, kGemmThreads, G::kSmemBytes, stream>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(dst), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// the two-kernel form: GEMM 1 into h, then GEMM 2
int launch_two(const void* x, const void* wp, const void* bp, const void* wo, const void* bo, void* out, void* h,
               int m, int c, int inner, cudaStream_t stream) {
  if (c % kGemmN != 0 || inner % kGemmN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int e = launch_gemm<true>(x, wp, bp, h, m, inner, c, 2 * inner, stream);
  return e != 0 ? e : launch_gemm<false>(h, wo, bo, out, m, c, inner, c, stream);
}

template <bool GEGLU>
int launch_gemm_f32(const void* a, const float* whi, const float* wlo, const void* bias, void* dst, int m, int n, int k,
                    int w_rows, cudaStream_t stream) {
  using G = GemmF32<GEGLU>;
  CUtensorMap ta, tbh, tbl;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!tensor_map(&ta, a, 1, m, k, G::kRows, kTBlk, CU_TENSOR_MAP_SWIZZLE_128B, f32) ||
      !tensor_map(&tbh, whi, 1, w_rows, k, kTN, kTBlk, CU_TENSOR_MAP_SWIZZLE_128B, f32) ||
      !tensor_map(&tbl, wlo, 1, w_rows, k, kTN, kTBlk, CU_TENSOR_MAP_SWIZZLE_128B, f32))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = set_smem(geglu_gemm_f32_kernel<GEGLU>, G::kSmemBytes);
  if (attr != 0) return attr;
  const dim3 grid(n / kTN, (m + G::kRows - 1) / G::kRows);  // a row block's column tiles run together (L2)
  geglu_gemm_f32_kernel<GEGLU><<<grid, kGemmThreads, G::kSmemBytes, stream>>>(
      ta, tbh, tbl, static_cast<const float*>(bias), static_cast<float*>(dst), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the weights' split pass into `planes` (wp_hi, wp_lo, wo_hi, wo_lo:
// 6 * c * inner values), GEMM 1 into h (m, inner), then GEMM 2
int launch_two_f32(const void* x, const void* wp, const void* bp, const void* wo, const void* bo, void* out, void* h,
                   void* planes, int m, int c, int inner, cudaStream_t stream) {
  if (c % kTN != 0 || inner % kTN != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = bind_device(x); err != cudaSuccess) return static_cast<int>(err);
  float* p = static_cast<float*>(planes);
  const long long np = 2LL * inner * c, no = (long long)c * inner;  // values of w_proj, of w_out
  float *wp_hi = p, *wp_lo = p + np, *wo_hi = p + 2 * np, *wo_lo = p + 2 * np + no;
  split_tf32_kernel<<<264, 256, 0, stream>>>(static_cast<const float4*>(wp), reinterpret_cast<float4*>(wp_hi),
                                             reinterpret_cast<float4*>(wp_lo), np / 4);
  split_tf32_kernel<<<264, 256, 0, stream>>>(static_cast<const float4*>(wo), reinterpret_cast<float4*>(wo_hi),
                                             reinterpret_cast<float4*>(wo_lo), no / 4);
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess) return static_cast<int>(err);
  const int e = launch_gemm_f32<true>(x, wp_hi, wp_lo, bp, h, m, inner, c, 2 * inner, stream);
  return e != 0 ? e : launch_gemm_f32<false>(h, wo_hi, wo_lo, bo, out, m, c, inner, c, stream);
}

}  // namespace

// fp32 (K2 at c 64, 320 and 640; K9 at 1024 and 1280): the two-kernel form
// with every product as three tf32 terms of hi + lo splits (3xTF32). x, wp,
// bp, wo, bo, out as below but fp32; h: (m, inner) fp32 scratch, GEMM 1's
// (a + ba) * gelu_erf(gate + bg); planes: 6 * c * inner fp32 scratch, the
// weights' tf32 hi and lo planes; c and inner multiples of 64.
extern "C" int vface_geglu_ff_two_f32(const void* x, const void* wp, const void* bp, const void* wo, const void* bo,
                                      void* out, void* h, void* planes, int m, int c, int inner, void* stream) {
  return launch_two_f32(x, wp, bp, wo, bo, out, h, planes, m, c, inner, static_cast<cudaStream_t>(stream));
}

// x: (m, c), wp: (2*inner, c), bp: (2*inner,), wo: (c, inner), bo: (c,), out: (m, c);
// all bf16, contiguous, 16-byte aligned; inner a multiple of 128; m >= 1. Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, 1, for a
// width or tile that is not built).

// The fused kernel at row tile tm: c 64 (tm 128) or 320 (tm 64 or 128). K2
// and K13 at c 64 and 320.
extern "C" int vface_geglu_ff_fused_bf16(const void* x, const void* wp, const void* bp, const void* wo,
                                         const void* bo, void* out, int m, int c, int inner, int tm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 64 && tm == 128) return launch_fused<64, 2, 32>(x, wp, bp, wo, bo, out, m, inner, st);
  if (c == 320 && tm == 128) return launch_fused<320, 2, 32>(x, wp, bp, wo, bo, out, m, inner, st);
  if (c == 320 && tm == 64) return launch_fused<320, 1, 32>(x, wp, bp, wo, bo, out, m, inner, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two-kernel form (GEMM 1 into h: (m, inner) bf16 scratch, then GEMM 2)
// on 128-row tiles, c a multiple of 128: K9 at c 1024 and 1280, K2 and K13 at
// c 640.
extern "C" int vface_geglu_ff_two_bf16(const void* x, const void* wp, const void* bp, const void* wo,
                                       const void* bo, void* out, void* h, int m, int c, int inner, void* stream) {
  return launch_two(x, wp, bp, wo, bo, out, h, m, c, inner, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the fused kernel at (c, tm), or of the two-kernel
// form's GEMM 1 (gemm = 1) and GEMM 2 (gemm = 2), in bytes (0 if not built).
extern "C" int vface_geglu_ff_smem_bytes(int c, int tm, int gemm) {
  if (gemm == 1) return Gemm<true>::kSmemBytes;
  if (gemm == 2) return Gemm<false>::kSmemBytes;
  if (c == 64 && tm == 128) return Fused<64, 2, 32>::kSmemBytes;
  if (c == 320 && tm == 128) return Fused<320, 2, 32>::kSmemBytes;
  if (c == 320 && tm == 64) return Fused<320, 1, 32>::kSmemBytes;
  return 0;
}
