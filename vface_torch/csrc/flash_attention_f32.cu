// Flash attention with fp32 operands for Hopper (sm_90a), on the tensor cores
// as 3xTF32: K8, and K7, K10, K11 and K12 on fp32 operands.
//
// Replaces vface_tpu/ops/pallas_attention.py::flash_attention (_flash_kernel,
// the k-tiled v1: K8) and, at fp32, the TPU kernels that compute its
// function: _archive_attention.py::flash_attention_v3 and _v4 (K10, K11),
// flash_attention_v6 (K12: P rounded to the operands' type, a no-op at fp32)
// and pallas_attention.py::_flash_v2_stats (K7, the STATS instantiation).
// Attention of (B, Nq, H*dh) queries over (B, Nk, H*dh) keys and values with
// every operand cast to fp32: s = (q . k^T) times dh^-0.5, an online softmax
// over 64-key tiles with fp32 running max m and sum l, P in fp32 in the P.V
// product, out = acc / l in fp32; Nq != Nk is allowed.
// STATS also writes each query row's final m (of the scaled scores) and l,
// fp32 (B*H, Nq); its output is the plain instantiation's bit for bit. bf16
// operands take K6's kernel (flash_attention.cu, SPLIT), which computes the
// same function, except at dh 32, which that kernel is not built for: the
// wrapper casts those to fp32 for this kernel (bf16 values are exact in tf32)
// and rounds the fp32 output once to bf16.
//
// What bounds it on the H100: two N^2-products (2*Nq*Nk*dh FLOPs each per
// head) and Nq*Nk exponentials per head, far above the bytes line. fp32
// operands need fp32-accurate products. The CUDA cores give those at 67
// TFLOP/s (FFMA); the tensor cores only through a multi-term split: with
// hi = tf32(x) and lo = tf32(x - hi), a.b ~ a_hi.b_hi + a_lo.b_hi + a_hi.b_lo
// to ~2^-21 relative (a_lo.b_lo lies below fp32's rounding), three tf32
// products at 495 TFLOP/s dense: 165 TFLOP/s of fp32-accurate products, 2.5x
// the FFMA line. At dh 40 the three products take ~4x as long as the
// exponentials on the SFUs, so the products at 165 TFLOP/s bound it
// (chip_smoke.py prints the FFMA line beside that bound as fp32_ffma_ms).
//
// The design is K1's (flash_attention.cu), with what tf32 changes:
// * wgmma reads 32-bit operands from shared memory K-major only (its
//   transpose modes are for 16-bit types), so V cannot be read in its
//   [key][dh] layout as K1 reads it. A split pass (split_kv_kernel) writes,
//   once per call, each 64-key tile's four planes side by side into a scratch
//   tensor the wrapper allocates: K_hi and K_lo as [dh/8][64 keys][8], V^T_hi
//   and V^T_lo as [8 key groups][dh][8], tf32-rounded fp32 values in 32-byte
//   rows, keys past Nk zero. Its bytes (4x K's and V's) are small beside the
//   N^2 products.
// * Each consumer thread loads its two rows of Q straight from (B, Nq, H*dh)
//   and splits them in registers into the hi and lo A fragments of S = Q.K^T
//   (dh registers): once, or at dh 80, for registers, before each tile (L1
//   hits); Q never passes through shared memory.
// * P never leaves registers: S's accumulator is split into P's hi and lo A
//   fragments. The m64n64 accumulator holds keys 2*t4 and 2*t4 + 1 of each
//   group of 8 where the tf32 A fragment takes columns t4 and t4 + 4; P.V
//   sums over the keys, so the split pass stores each group of 8 keys of V^T
//   in the order 0 2 4 6 1 3 5 7 (perm8), and the accumulator's registers
//   are the A fragment as they stand.
// * One CTA owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows, and a producer warpgroup whose first lane keeps a
//   ring of slots (160 KB: 4 at dh <= 40, 2 at dh 80 and 160) filled by
//   TMA in 256-row boxes through the 32-byte swizzle, completed on mbarriers
//   (full: the bytes landed; empty: every consumer warp is done with the
//   slot). Up to dh 80 a slot holds one key tile's four planes, waited for
//   once and released once a tile. At dh 160 those are 160 KB, so a slot
//   holds a tile's K planes or its V^T planes, the two in turn, each waited
//   for and released on its own: K(j + 1) loads while P(j).V(j) runs and
//   V(j + 1) while S(j + 1) does. The producer hands
//   its registers to the consumers (setmaxnreg 24 / 240): a consumer holds
//   Q's fragments (dh registers), S (32), the running output and one tile's
//   P.V (dh / 2 each; at dh 80 and 160 the tile's in blocks of 40 columns)
//   and P's hi and lo fragments (64).
// * At dh 160 Q's fragments (160 registers) and S's 40 descriptor registers
//   do not fit beside the 80-register output: S is issued in ten groups of
//   16 columns, each loading its Q fragments (L1 hits) into a fresh
//   accumulator that the CUDA cores add to S, as the P.V tiles are summed
//   (five groups of 32 columns spilled 168 bytes). That chain runs one CTA
//   per 128 query rows, 64 CTAs on 132 SMs at a train step's (1, 1024,
//   1280): 0.193 ms against SDPA's 0.188 (NVIDIA H100 80GB HBM3 at 700 W,
//   vface_torch/bench/attn_fwd_wide.py).
// * So at dh 160, where the grid of two CTAs per 128 query rows fits in one
//   wave (flash_attention.f32_cluster), the kernel runs on clusters of two
//   CTAs, each over 80 of dh's columns (CLUSTER): the split pass writes dh
//   160 as two heads of 80, so each CTA's slots, Q fragments and products
//   are the dh-80 kernel's and S runs in one group. Each consumer
//   warpgroup stores its partial S in shared memory, one thread copies it
//   into the peer CTA's with one bulk copy completing on the peer's
//   mbarrier, and each adds the other's partial to its own (a + b and b + a,
//   the same bits), so both form the same P; each then computes P.V for its
//   own 80 output columns. At (1, 1024, 1280): 0.136 ms (0.108 without the
//   exchange). Where the grid is larger, the SMs are full either way and the
//   chain above, at half the CTAs, is faster: at (12, 576, 1280) 0.487 ms
//   against the clusters' 0.534 (0.438 without the exchange).
// * Per tile each warpgroup issues S = Q_lo.K_hi^T + Q_hi.K_lo^T +
//   Q_hi.K_hi^T (3 * dh / 8 wgmma of m64n64k8, the small terms first) as one
//   group, waits, runs the softmax (one FFMA and one ex2 a score; only a
//   ragged last tile is masked), splits P, and issues P_lo.V^T_hi +
//   P_hi.V^T_lo + P_hi.V^T_hi (24 wgmma of N = dh; at dh 80 two groups of
//   N = 40, for registers) as a second group into a fresh accumulator, which
//   it adds to the rescaled running output with FFMAs: the tensor cores' fp32
//   sums do not round to nearest, and summed over a whole row of keys on
//   them the error grew with Nk, past 1e-5 of the output's peak at Nk = 4096.
//   The other warpgroup's products fill the tensor cores while one runs its
//   softmax. Every operand register of a group is pinned before its
//   wgmma.fence (ptxas serializes every wgmma of the kernel otherwise,
//   C7513), and no group is in flight across the loop's back edge (C7515).
// * Each row walks its keys in one fixed order: two launches are equal bit
//   for bit.
// dh is one of 16, 32, 40, 80 and 160 (the JAX tests' widths and the UNet's
// ds1, ds2 and ds4); other widths are refused.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBlockK = 64;      // keys per tile: the softmax block
constexpr int kNC = 2;           // consumer warpgroups, 64 query rows each
constexpr int kRows = 64 * kNC;  // query rows per CTA
// The consumers and a producer warpgroup that gives its registers to them:
// the CTA launches at 168 a thread (a quarter of the register file holds 3
// warps), and 24 + 2 * 240 = 3 * 168 keeps the pool whole.
constexpr int kThreads = 128 * kNC + 128, kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBoxRows = 256;  // 32-byte rows per TMA box of the scratch tensor
constexpr float kLog2e = 1.4426950408889634f;

// items of the ring a key tile takes: its four planes as one, or at dh 160
// its K planes and then its V^T planes
template <int DH>
constexpr int kParts = DH == 160 ? 2 : 1;
// slots of the ring, each holding one item: 160 KB of slots at every width
template <int DH>
constexpr int kSlots = DH <= 40 ? 4 : 2;

// A slot's planes, each 8 * DH rows of 8 fp32 values in TMA's 32-byte
// swizzle: K_hi and K_lo as [DH / 8][64 keys][8], then (or, at dh 160, in
// the next item) V^T_hi and V^T_lo as [8 key groups][DH][8] with each
// group's keys in perm8 order. Key tile j's K is item kParts * j of the ring,
// its V^T item kParts * j + kParts - 1: item i in slot i % kSlots.
template <int DH>
struct Smem {
  float kv[kSlots<DH>][4 / kParts<DH>][8 * DH][8];
  uint64_t full[kSlots<DH>], empty[kSlots<DH>];
};
// dh 160 when one wave holds the grid: two halves of 80 columns, one on each CTA of a cluster of two
constexpr int kHalf = 80;
// The cluster form's: beside the slots, each consumer warpgroup's partial S
// (mine) and the peer CTA's (x), [warpgroup][register quad][thread], and x's
// barriers.
struct ClusterSmem : Smem<kHalf> {
  float4 mine[kNC][8][128], x[kNC][8][128];
  uint64_t xfull[kNC], xempty[kNC];
};
template <int DH, bool CLUSTER>
using SmemOf = std::conditional_t<CLUSTER, ClusterSmem, Smem<DH>>;
template <int DH, bool CLUSTER = false>
constexpr int kSmemBytes = sizeof(SmemOf<DH, CLUSTER>) + 1024;  // + the slack to align it to 1024 bytes
static_assert(kSmemBytes<kHalf, true> <= 232448, "over the shared memory of a block");

// Position i of a group of 8 keys of V^T holds key perm8(i): 0 2 4 6 1 3 5 7,
// so that the tf32 A fragment's columns t4 and t4 + 4 are the accumulator's
// keys 2*t4 and 2*t4 + 1.
__device__ __forceinline__ int perm8(int i) { return 2 * (i & 3) + (i >> 2); }

// The split pass: one CTA per (64-key tile j, batch * head) stages the tile's
// keys and values (zeros past nk) and writes its four planes, split
// into tf32 hi and lo, to kv[bh][j] (4 * 64 * DH values).
// The tile is staged through shared memory in column blocks of at most 80
// (at dh 160 the whole tile's 82 KB would pass the 48 KB of static shared
// memory); K's rows of a block are whole 8-column groups.
template <int DH>
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kv, int nk, int heads) {
  constexpr int CW = DH <= 80 ? DH : 80;  // columns staged at once
  __shared__ float sk[kBlockK][CW + 1], sv[kBlockK][CW + 1];
  const int j = blockIdx.x, bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const long long cols = (long long)heads * DH;
  constexpr int P = kBlockK * DH;  // values per plane
  float* out = kv + ((long long)bh * gridDim.x + j) * 4 * P;
  for (int c0 = 0; c0 < DH; c0 += CW) {
    if (c0) __syncthreads();  // the last block's reads are done
    for (int i = threadIdx.x; i < kBlockK * CW; i += blockDim.x) {
      const int r = i / CW, d = i - r * CW, key = j * kBlockK + r;
      float kx = 0.f, vx = 0.f;
      if (key < nk) {
        const long long off = ((long long)b * nk + key) * cols + h * DH + c0 + d;
        kx = k[off];
        vx = v[off];
      }
      sk[r][d] = kx;
      sv[r][d] = vx;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * CW; i += blockDim.x) {
      uint32_t hi, lo;
      // K: plane row = column block * 64 + key; this block's rows start at c0 / 8 * 64
      const int o = c0 * kBlockK + i, row = i >> 3, c = i & 7;
      split_tf32(sk[row & 63][8 * (row >> 6) + c], hi, lo);
      out[o] = __uint_as_float(hi);
      out[P + o] = __uint_as_float(lo);
      // V^T: plane row = key group * DH + column; this block holds columns c0 .. c0 + CW
      const int kg = row / CW, d = row - kg * CW, ov = (kg * DH + c0 + d) * 8 + c;
      split_tf32(sv[8 * kg + perm8(c)][d], hi, lo);
      out[2 * P + ov] = __uint_as_float(hi);
      out[3 * P + ov] = __uint_as_float(lo);
    }
  }
}

// CLUSTER (dh 160 when one wave holds the grid): CTA `rank` of a cluster of
// two over one tile of query rows computes dh's columns DH * rank .. DH *
// rank + DH - 1 (DH = 80), from the split pass's head 2 * bh + rank, and
// exchanges its partial S with the other CTA.
template <int DH, bool STATS, bool CLUSTER = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tkv, const float* __restrict__ q, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int nq, int nk, int heads, float scale) {
  constexpr int NB = DH / 8;  // k8 steps of Q.K^T
  constexpr int SL = kSlots<DH>, PT = kParts<DH>;
  extern __shared__ uint8_t smem_raw[];
  auto& sm = *reinterpret_cast<SmemOf<DH, CLUSTER>*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const uint32_t rank = CLUSTER ? cluster_ctarank() : 0u;
  const int q0 = (CLUSTER ? blockIdx.x >> 1 : blockIdx.x) * kRows;
  const int n_kt = (nk + kBlockK - 1) / kBlockK;
  const int active = min(kNC, (nq - q0 + 63) / 64);  // warpgroups with a row below nq

  if (tid == 0) {
    for (int s = 0; s < SL; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * active);  // one arrival per consumer warp
    }
    if constexpr (CLUSTER) {
      for (int w = 0; w < kNC; ++w) {
        mbar_init(&sm.xfull[w], 1);   // the peer's partial S: its bytes, armed here and by wg's thread 0
        mbar_init(&sm.xempty[w], 4);  // the peer has read this CTA's partial: one arrival per peer consumer warp
        mbar_expect_tx(&sm.xfull[w], sizeof(sm.x[0]));  // tile 0's
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CLUSTER) cluster_sync();  // both CTAs' barriers are initialised before either uses the other's
  else __syncthreads();

  if (tid >= 128 * kNC) {  // the producer warpgroup: its first thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kNC) {
      constexpr int kItemRows = 32 / PT * DH;  // a tile's 32 * DH scratch rows, in PT items
      const int hv = CLUSTER ? 2 * bh + static_cast<int>(rank) : bh;  // the split pass's head
      for (int i = 0; i < PT * n_kt; ++i) {
        const int st = i % SL;
        mbar_wait(&sm.empty[st], ((i / SL) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], sizeof(sm.kv[0]));
        for (int c = 0; c < kItemRows / kBoxRows; ++c)
          tma_load(&sm.kv[st][0][0][0] + c * kBoxRows * 8, &tkv, &sm.full[st], 0, i * kItemRows + c * kBoxRows, hv);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  if (wg >= active) return;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const long long cols = (long long)heads * DH * (CLUSTER ? 2 : 1);
  const int col0 = CLUSTER ? (2 * h + static_cast<int>(rank)) * DH : h * DH;  // this CTA's first column

  // Q's hi and lo A fragments: k8 step cb in registers 4cb .. 4cb + 3, rows
  // (row0, row0 + 8, row0, row0 + 8) at columns (t4, t4, t4 + 4, t4 + 4).
  // Loaded once at dh <= 40; at dh 80 their 80 registers do not fit beside
  // the rest (ptxas spilled 136 bytes), and each tile reloads them (L1 hits);
  // at dh 160 each of S's QC groups loads its CB steps' (L1 hits).
  constexpr bool kQResident = DH <= 40;
  constexpr int QC = DH == 160 ? 10 : 1, CB = NB / QC;  // S's groups, k8 steps each (at dh 160 five groups spilled)
  uint32_t qhi[4 * CB], qlo[4 * CB];
  const float* qb = q + (long long)b * nq * cols + col0;
  auto load_q = [&](int qc) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1);
        const float x = row < nq ? qb[row * cols + 8 * (qc * CB + cb) + t4 + 4 * (e >> 1)] : 0.f;
        split_tf32(x, qhi[4 * cb + e], qlo[4 * cb + e]);
      }
    }
    pin(qhi);
    pin(qlo);
  };
  if constexpr (kQResident) load_q(0);

  // Descriptors in 16-byte units: K's k8 steps are its column blocks, 64
  // keys * 32 bytes apart; V^T's are its key groups, DH rows * 32 bytes apart.
  // Every operand register of a wgmma group (descriptors, the accumulate
  // flag, the A fragments, the accumulators) is defined before the group's
  // wgmma.fence and pinned there.
  uint32_t one = 1, zero = 0;
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t d0 = sdesc(&sm.kv[0][0][0][0], 16, 256);
  constexpr uint64_t kPlane = sizeof(sm.kv[0][0]) >> 4, kSlot = sizeof(sm.kv[0]) >> 4;
  uint64_t dk[2 * CB], dv[16];  // hi steps, then lo steps
  // P.V in NH blocks of DN output columns: at dh 80 and 160 blocks of 40, for
  // registers (one of 80 spilled 88 bytes)
  constexpr int NH = DH >= 80 ? DH / 40 : 1, DN = DH / NH;
  auto k_descs = [&](int st, int qc) {  // K's k8 steps qc * CB .. qc * CB + CB - 1
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      dk[cb] = d0 + st * kSlot + (qc * CB + cb) * (kBlockK * 32 >> 4);
      dk[CB + cb] = dk[cb] + kPlane;
    }
    pin(dk);
  };
  auto v_descs = [&](int st, int hb) {  // column block hb: DN rows of each key group
#pragma unroll
    for (int kg = 0; kg < 8; ++kg) {
      dv[kg] = d0 + st * kSlot + (PT == 1 ? 2 * kPlane : 0) + kg * (DH * 32 >> 4) + hb * (DN * 32 >> 4);
      dv[8 + kg] = dv[kg] + kPlane;
    }
    pin(dv);
  };
  // one group of S's terms over Q's loaded steps: Q_lo.K_hi^T + Q_hi.K_lo^T +
  // Q_hi.K_hi^T, the small terms first, into sc (sc's old values unread)
  auto qk = [&](float (&sc)[32]) {
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (cb == 0) wgmma_tf32_n64_zero(sc, &qlo[0], dk[0], zero);
      else wgmma_tf32_n64(sc, &qlo[4 * cb], dk[cb], one);
    }
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) wgmma_tf32_n64(sc, &qhi[4 * cb], dk[CB + cb], one);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) wgmma_tf32_n64(sc, &qhi[4 * cb], dk[cb], one);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
  };

  // CLUSTER: this warpgroup's partial S goes to the peer's x[wg] (once the
  // peer has read the last one, and so its copy has read mine[wg]) by one
  // bulk copy of mine[wg] that completes on the peer's xfull[wg], and the
  // peer's comes into this CTA's x[wg]; each CTA adds the other's to its own,
  // a + b on one and b + a on the other, which are the same bits, so both
  // form the same P. Each warp's lane 0 tells the peer that the warp has read
  // its partial (__syncwarp orders the reads before the release); the
  // warpgroup's thread 0 arms xfull[wg] for the next tile before its warp's
  // release, so no copy of that tile can come first. (Stores of 16 bytes
  // each straight into the peer, st_async_peer, took 4 % longer.)
  uint32_t x_peer = 0, xfull_peer = 0, xempty_peer = 0;
  if constexpr (CLUSTER) {
    x_peer = peer_addr(&sm.x[wg][0][0], rank ^ 1u);
    xfull_peer = peer_addr(&sm.xfull[wg], rank ^ 1u);
    xempty_peer = peer_addr(&sm.xempty[wg], rank ^ 1u);
  }
  auto exchange = [&](float (&s)[32], int j) {
    if constexpr (CLUSTER) {
      const int t = tid & 127;
      if (j > 0) mbar_wait<true>(&sm.xempty[wg], (j - 1) & 1);
#pragma unroll
      for (int r = 0; r < 8; ++r) sm.mine[wg][r][t] = make_float4(s[4 * r], s[4 * r + 1], s[4 * r + 2], s[4 * r + 3]);
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (t == 0) bulk_copy_peer(x_peer, &sm.mine[wg][0][0], sizeof(sm.mine[0]), xfull_peer);
      mbar_wait(&sm.xfull[wg], j & 1);
      if (t == 0 && j + 1 < n_kt) mbar_expect_tx(&sm.xfull[wg], sizeof(sm.x[0]));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 x = sm.x[wg][r][t];
        s[4 * r] += x.x;
        s[4 * r + 1] += x.y;
        s[4 * r + 2] += x.z;
        s[4 * r + 3] += x.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive_peer(xempty_peer);
    }
  };

  const float c = scale * kLog2e;             // scores to log2 units in the exponent's FFMA
  const int tail = nk - (n_kt - 1) * kBlockK;  // valid keys of the last tile
  // o: the running output, summed over tiles on the CUDA cores (fp32, round
  // to nearest); acc: one tile's P.V on the tensor cores. The tensor cores'
  // fp32 sums do not round to nearest, and over a whole row of keys (6144
  // wgmma at Nk = 16384) their error grew past 1e-5 of the output's peak.
  float o[DH / 2], acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float s[32], mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
  uint32_t phi[32], plo[32];

  for (int j = 0; j < n_kt; ++j) {
    const int sk = (PT * j) % SL, sv = (PT * j + PT - 1) % SL;
    mbar_wait(&sm.full[sk], ((PT * j) / SL) & 1);
    __syncwarp();

    // S = Q_lo.K_hi^T + Q_hi.K_lo^T + Q_hi.K_hi^T
    if constexpr (QC == 1) {
      if constexpr (!kQResident) load_q(0);
      k_descs(sk, 0);
      qk(s);
      exchange(s, j);
    } else {  // QC groups of CB steps, each into sc, added to s on the CUDA cores
      float sc[32];
#pragma unroll 1
      for (int qc = 0; qc < QC; ++qc) {
        load_q(qc);
        k_descs(sk, qc);
        qk(sc);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = qc ? s[i] + sc[i] : sc[i];
      }
    }
    if constexpr (PT == 2) {
      if (lane == 0) mbar_arrive(&sm.empty[sk]);  // K(j)'s slot is free
    }

    if (j == n_kt - 1 && tail < kBlockK) softmax_tile<true>(s, mr, l, al, c, tail, t4);
    else softmax_tile<false>(s, mr, l, al, c, kBlockK, t4);
    // P's A fragments: step kg's columns t4 and t4 + 4 hold keys 8kg + 2*t4
    // and 8kg + 2*t4 + 1 (perm8), S's registers 4kg + (0, 2) and 4kg + (1, 3)
#pragma unroll
    for (int kg = 0; kg < 8; ++kg) {
      split_tf32(s[4 * kg], phi[4 * kg], plo[4 * kg]);
      split_tf32(s[4 * kg + 2], phi[4 * kg + 1], plo[4 * kg + 1]);
      split_tf32(s[4 * kg + 1], phi[4 * kg + 2], plo[4 * kg + 2]);
      split_tf32(s[4 * kg + 3], phi[4 * kg + 3], plo[4 * kg + 3]);
    }

    // acc = P_lo.V^T_hi + P_hi.V^T_lo + P_hi.V^T_hi; o = o * alpha + acc,
    // per block of DN columns
    if constexpr (PT == 2) {
      mbar_wait(&sm.full[sv], ((2 * j + 1) / SL) & 1);
      __syncwarp();
    }
    pin(phi);
    pin(plo);
#pragma unroll
    for (int hb = 0; hb < NH; ++hb) {
      v_descs(sv, hb);
      wgmma_fence();
#pragma unroll
      for (int kg = 0; kg < 8; ++kg) {
        if (kg == 0) wgmma_tf32_dh<DN, true>(acc, &plo[0], dv[0], zero);
        else wgmma_tf32_dh<DN>(acc, &plo[4 * kg], dv[kg], one);
      }
#pragma unroll
      for (int kg = 0; kg < 8; ++kg) wgmma_tf32_dh<DN>(acc, &phi[4 * kg], dv[8 + kg], one);
#pragma unroll
      for (int kg = 0; kg < 8; ++kg) wgmma_tf32_dh<DN>(acc, &phi[4 * kg], dv[kg], one);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i)
        o[hb * DN / 2 + i] = fmaf(o[hb * DN / 2 + i], al[(i >> 1) & 1], acc[i]);
    }
    if (lane == 0) mbar_arrive(&sm.empty[sv]);  // V^T(j)'s slot (K(j)'s too below dh 160) is free
  }
  if constexpr (CLUSTER)
    mbar_wait<true>(&sm.xempty[wg], (n_kt - 1) & 1);  // the peer has read the last partial: nothing more comes in

  // ---- out = o / l (the TPU kernel's division), written strided into
  // (B, Nq, H*dh)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nq) continue;
    float* orow = out + ((long long)b * nq + row) * cols + col0;
#pragma unroll
    for (int jc = 0; jc < DH / 8; ++jc)
      *reinterpret_cast<float2*>(orow + 8 * jc + 2 * t4) =
          make_float2(o[4 * jc + 2 * r] / l[r], o[4 * jc + 2 * r + 1] / l[r]);
    if (STATS && t4 == 0 && rank == 0) {  // the quad's four lanes (and both CTAs) hold the same m and l
      m_out[(long long)bh * nq + row] = mr[r] * scale;
      l_out[(long long)bh * nq + row] = l[r];
    }
  }
}

// ---- host side (tensor maps: hopper.cuh)

// CL (dh 160 only): the split pass writes two heads of 80 columns, one for
// each CTA of a cluster of two
template <int DH, bool STATS, bool CL = false>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, float* kv, int b, int nq,
           int nk, int heads, float scale, cudaStream_t stream) {
  if (const cudaError_t err = bind_device(q); err != cudaSuccess) return static_cast<int>(err);
  constexpr int DS = CL ? kHalf : DH, HS = DH / DS;
  const int n_kt = (nk + kBlockK - 1) / kBlockK, n_qt = (nq + kRows - 1) / kRows;
  CUtensorMap tkv;  // the scratch tensor as (b * heads * HS) x (n_kt * 32 * DS rows) x 8 fp32 values
  if (!tensor_map(&tkv, kv, b * heads * HS, n_kt * 32 * DS, 8, kBoxRows, 8, CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kSmemBytes<DS, CL>;
  const auto kernel = flash_tf32_kernel<DS, STATS, CL>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split_kv_kernel<DS><<<dim3(n_kt, b * heads * HS), 256, 0, stream>>>(static_cast<const float*>(k),
                                                                     static_cast<const float*>(v), kv, nk, heads * HS);
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess) return static_cast<int>(err);
  if constexpr (CL) {  // a cluster of two CTAs per 128 query rows
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * n_qt, b * heads);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[1];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = 2;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tkv, static_cast<const float*>(q),
                                               static_cast<float*>(o), m, l, nq, nk, heads, scale);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    flash_tf32_kernel<DS, STATS, CL><<<dim3(n_qt, b * heads), kThreads, kSmem, stream>>>(
        tkv, static_cast<const float*>(q), static_cast<float*>(o), m, l, nq, nk, heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int dispatch_f32(const void* q, const void* k, const void* v, void* o, void* m, void* l, void* kv, int b, int nq,
                 int nk, int heads, int dh, float scale, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *mm = static_cast<float*>(m), *ll = static_cast<float*>(l), *kk = static_cast<float*>(kv);
  if (nq < 1 || nk < 1 || (cluster && dh != 160)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch<16, STATS>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st);
    case 32: return launch<32, STATS>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st);
    case 40: return launch<40, STATS>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st);
    case 80: return launch<80, STATS>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st);
    case 160:
      return cluster ? launch<160, STATS, true>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st)
                     : launch<160, STATS>(q, k, v, o, mm, ll, kk, b, nq, nk, heads, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (b, nq, heads * dh); k, v: (b, nk, heads * dh); contiguous and 16-byte
// aligned; kv: the split pass's scratch, b * heads * ceil(nk / 64) * 4 * 64 *
// dh fp32 values; cluster: 1 runs dh 160 on clusters of two CTAs, each over
// half of dh's columns (0 at every other width). Each launches the split
// pass, then the attention kernel, and returns cudaGetLastError() after them.

// fp32, dh one of 16, 32, 40, 80, 160.
extern "C" int vface_flash_attention_v1_f32(const void* q, const void* k, const void* v, void* o, void* kv, int b,
                                            int nq, int nk, int heads, int dh, float scale, int cluster,
                                            void* stream) {
  return dispatch_f32<false>(q, k, v, o, nullptr, nullptr, kv, b, nq, nk, heads, dh, scale, cluster, stream);
}

// fp32 that also writes m, l: (b * heads, nq) fp32, each row's final running
// max (of the scaled scores) and softmax denominator.
extern "C" int vface_flash_attention_v1_stats_f32(const void* q, const void* k, const void* v, void* o, void* m,
                                                  void* l, void* kv, int b, int nq, int nk, int heads, int dh,
                                                  float scale, int cluster, void* stream) {
  return dispatch_f32<true>(q, k, v, o, m, l, kv, b, nq, nk, heads, dh, scale, cluster, stream);
}

// Dynamic shared memory of the attention kernel at head width dh, in bytes (0 if none is built).
extern "C" int vface_flash_attention_f32_smem_bytes(int dh) {
  switch (dh) {
    case 16: return kSmemBytes<16>;
    case 32: return kSmemBytes<32>;
    case 40: return kSmemBytes<40>;
    case 80: return kSmemBytes<80>;
    case 160: return kSmemBytes<160>;
    default: return 0;
  }
}
