// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out: K1, K4,
// K6 and K7.
//
// Replaces vface_tpu/ops/pallas_attention.py::flash_attention_v5
// (_flash_kernel_v5 via _flash_v5_impl): multi-head attention of (B, Nq, H*dh)
// queries over (B, Nk, H*dh) keys and values, s = (q . k^T) in fp32 times
// dh^-0.5, an online softmax over 64-key blocks whose running max m and sum l
// stay in fp32, P rounded to bf16 before the P.V product, fp32 accumulation,
// and out = bf16(acc / l). The STATS instantiation also replaces
// _flash_v5_stats (_flash_kernel_v5_stats), the forward of the training VJP:
// the same kernel, which in addition writes each row's final m (natural-log
// units, of the scaled scores) and l in fp32 to (B*H, Nq). Its output is the
// plain instantiation's bit for bit: only the epilogue differs.
//
// The SPLIT instantiations replace _flash_v2_impl (_flash_kernel_v2, K6: the
// forward that flash_attention_bwd recomputes O with) and, with STATS,
// _flash_v2_stats (_flash_kernel_v2_stats, K7 at bf16): the same attention
// with P kept at fp32 precision in P.V. Each P value is split in registers
// into hi = bf16(p) and lo = bf16(p - hi), and P.V runs as two register-operand
// wgmma groups, hi then lo, into the one fp32 accumulator: the pair carries
// ~16 significant bits, far below the one rounding of the output. K7's output
// is K6's bit for bit.
//
// What bounds it on the H100, at the UNet's self-attention sites:
// * ds1 (N = 4096, dh = 40, padded to 48): the exponentials on paper. Every
//   score needs one ex2 on the SFU, 16 per clock per SM, against 4*48 FLOPs
//   at ~4096 bf16 tensor FLOPs per clock per SM: the N^2 exps take longer
//   (~0.39 ms at b 12) than the two products at dh 48 (~0.31 ms).
// * ds2 (N = 1024, dh = 80): the tensor cores and the exps about equally.
// * Both: the K/V traffic through L2. Every CTA streams its head's whole K and
//   V once, so the bytes per call scale with Nq over the q rows per CTA.
// * In practice the latency of each warpgroup's chain, S -> softmax -> P.V:
//   on the card the kernel runs as fast with its ex2 replaced by an FFMA, and
//   what moved it was keeping the wgmma groups asynchronous and more
//   warpgroups per SM (PERF.md, K1).
//
// What the design does about each:
// * One CTA owns 64 * NC query rows of one (batch, head): NC = 3 (or 2)
//   consumer warpgroups of 64 rows share each K/V tile, a third (a half) of
//   the L2 traffic of 64-row tiles. The wrapper picks NC from the grid and
//   the card's SM count (flash_attention.py::k1_consumers): 128-row tiles
//   where 192-row ones give fewer than two CTAs per SM (the train step's
//   b = 1). With the producer warp, NC = 3 is 13 warps, which ptxas caps at
//   128 registers a thread (NC = 2: 168). At dh 160 (SD-v1's ds4 sites above
//   512^2) a consumer holds a 64 x 160 fp32 output (80 registers), S (32), P
//   (16, SPLIT 32) and 48 descriptor registers, past 168: that width is built
//   at NC = 2 with a producer warpgroup instead of the warp, which hands its
//   registers to the consumers (setmaxnreg 24 / 240, as K5's kernels do;
//   Q's 40 KB and four 40 KB K/V stages fit in 227 KB of shared memory).
//   A producer warp keeps a ring of 4 K/V stages filled by TMA,
//   completed on mbarriers (full: the bytes landed; empty: every consumer warp
//   is done with the stage), so later tiles load while this one computes.
// * Both products run on wgmma with fp32 accumulators: S = Q.K^T with Q and K
//   as K-major shared-memory operands; O += P.V with P as the register operand
//   (S's accumulator rounded to bf16 pairs in place, never stored) and V read
//   in its natural [key][dh] layout through wgmma's transposed-B mode.
// * Each warpgroup issues S(j) = Q.K(j)^T and O += P(j-1).V(j-1) together and
//   runs the softmax of tile j while P(j-1).V(j-1) is on the tensor cores;
//   the other warpgroups of the SM fill the tensor cores while it waits for S.
//   Every operand register of a wgmma group is defined before the group's
//   wgmma.fence (ptxas otherwise serializes every wgmma of the kernel, C7513).
// * Each score costs one FFMA (scale*log2(e) folded in) and one ex2; only the
//   last key tile, when Nk is ragged, is masked; the quad's partial row sums
//   are added once at the end.
//
// Layout: heads are read strided straight out of (B, N, H*dh) by 3-D tensor
// maps (columns, rows, batch), with no split-heads copy. Each TMA box is 16
// columns (32 bytes) by 64 or 64 * NC rows and lands with TMA's 32-byte swizzle,
// which is the wgmma operand layout of that swizzle for both majors: 16
// columns are one k16 step of Q.K^T and 16 output columns of P.V. dh is padded
// to 16/48/80/160 in shared memory: a padded head's box reads the next head's
// first columns (zeros past the last head, and past N, which TMA fills), so
// the kernel zeroes Q's padding columns; K's then multiply zeros (the inputs
// are finite), and V's land only in output columns that are not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockK = 64;  // keys per K/V tile: the softmax block
constexpr int kStages = 4;   // K/V tiles in flight

// dh 160: a producer warpgroup that gives its registers to the consumers
template <int DHP>
constexpr bool kWide = DHP > 80;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 24 + 2 * 240 = 3 * 168: the pool stays whole

// NC consumer warpgroups of 64 q rows each, and one producer warp (a
// producer warpgroup at dh 160)
template <int DHP, int NC>
constexpr int kThreads = 128 * NC + (kWide<DHP> ? 128 : 32);

// [column block][row][16 columns]; TMA swaps the two 16-byte halves of rows
// 4-7 of every 8 (32-byte swizzle: address bit 4 ^= bit 7)
template <int DHP, int NC>
struct Smem {
  __nv_bfloat16 q[DHP / kAtom][64 * NC][kAtom];
  __nv_bfloat16 k[kStages][DHP / kAtom][kBlockK][kAtom];
  __nv_bfloat16 v[kStages][DHP / kAtom][kBlockK][kAtom];
  uint64_t q_full, full[kStages], empty[kStages];
};
template <int DHP, int NC>
constexpr int kSmemBytes = sizeof(Smem<DHP, NC>) + 1024;  // + the slack to align it to 1024 bytes

template <int DHP, int NC, bool STATS, bool SPLIT>
__global__ void __launch_bounds__(kThreads<DHP, NC>, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int nq, int nk, int heads, int dh,
                      float scale) {
  constexpr int NB = DHP / kAtom;  // 16-column blocks: k16 steps of Q.K^T
  extern __shared__ uint8_t smem_raw[];
  Smem<DHP, NC>& sm =
      *reinterpret_cast<Smem<DHP, NC>*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * 64 * NC;
  const int n_kt = (nk + kBlockK - 1) / kBlockK;
  const int col0 = h * dh;
  const int active = min(NC, (nq - q0 + 63) / 64);  // warpgroups with a row below nq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * active);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NC) {  // the producer warp (warpgroup): one thread issues every load
    if constexpr (kWide<DHP>) setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * NC) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      for (int c = 0; c < NB; ++c) tma_load(&sm.q[c][0][0], &tq, &sm.q_full, col0 + c * kAtom, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], sizeof(sm.k[0]) + sizeof(sm.v[0]));
        for (int c = 0; c < NB; ++c) {
          tma_load(&sm.k[st][c][0][0], &tk, &sm.full[st], col0 + c * kAtom, j * kBlockK, b);
          tma_load(&sm.v[st][c][0][0], &tv, &sm.full[st], col0 + c * kAtom, j * kBlockK, b);
        }
      }
    }
    return;
  }

  if constexpr (kWide<DHP>) setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid >> 7;
  if (wg >= active) return;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  mbar_wait(&sm.q_full, 0);
  __syncwarp();
  if (dh < DHP) zero_pad<DHP, 64 * NC>(sm.q, wg * 64, dh, tid & 127, 1 + wg);  // Q's padding columns

  auto wait_full = [&](int j) {
    mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    __syncwarp();
  };

  // Descriptors in 16-byte units: Q's k16 steps are its column blocks, as are
  // K's; V's k16 steps are 16 keys (512 bytes), its 16-column blocks kBlockK *
  // 32 bytes apart. Every operand register of a wgmma group (descriptors, the
  // accumulate flag, P and its lo half, the accumulators) is defined before
  // the group's wgmma.fence and pinned there: ptxas serializes all wgmmas of
  // the kernel if an instruction defines one inside a group.
  uint32_t one = 1, zero = 0;
  uint64_t dq[NB];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) dq[cb] = sdesc(&sm.q[cb][wg * 64][0], 16, 256);
  pin(dq);
  asm volatile("" : "+r"(one), "+r"(zero));
  const uint64_t dk0 = sdesc(&sm.k[0][0][0][0], 16, 256);
  const uint64_t dv0 = sdesc(&sm.v[0][0][0][0], kBlockK * 32, 256);
  constexpr uint64_t kStage = sizeof(sm.k[0]) >> 4;  // one K (or V) stage
  uint64_t dk[NB], dv[4];
  auto qk = [&](float (&s)[32]) {  // S = Q.K^T
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      if (cb == 0) wgmma_ss_n64_zero(s, dq[0], dk[0], zero);
      else wgmma_ss_n64(s, dq[cb], dk[cb], one);
    }
  };
  constexpr int NL = SPLIT ? 16 : 1;  // registers of P's lo half
  auto pv = [&](float (&acc)[DHP / 2], const uint32_t (&p)[16], const uint32_t (&pl)[NL]) {  // acc += P.V
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_rs_mn<DHP>(acc, &p[4 * kc], dv[kc], one);
      if constexpr (SPLIT) wgmma_rs_mn<DHP>(acc, &pl[4 * kc], dv[kc], one);
    }
  };
  auto k_descs = [&](int j) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) dk[cb] = dk0 + (j % kStages) * kStage + cb * (kBlockK * 32 >> 4);
    pin(dk);
  };
  auto v_descs = [&](int j) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) dv[kc] = dv0 + (j % kStages) * kStage + kc * (16 * 32 >> 4);
    pin(dv);
  };

  const float c = scale * 1.4426950408889634f;  // scores to log2 units in the exponent's FFMA
  const int tail = nk - (n_kt - 1) * kBlockK;   // valid keys of the last tile
  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  float s[32], mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
  uint32_t p[16], pl[NL];
  // softmax_tile (hopper.cuh) leaves P in S's accumulator layout; packed to
  // bf16 pairs it is the A operand of P.V as it stands: pairs 8kc..8kc+7 hold
  // keys 16kc..16kc+15
  auto pack = [&] {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (SPLIT) split_pack(s[2 * i], s[2 * i + 1], p[i], pl[i]);
      else p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
    }
  };

  // Tile j: S(j) = Q.K(j)^T and P(j-1).V(j-1) go to the tensor cores
  // together; the softmax of S(j) runs while P(j-1).V(j-1) is in flight.
  wait_full(0);
  k_descs(0);
  wgmma_fence();
  qk(s);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  if (n_kt == 1 && tail < kBlockK) softmax_tile<true>(s, mr, l, al, c, tail, t4);
  else softmax_tile<false>(s, mr, l, al, c, kBlockK, t4);
  pack();

  for (int j = 1; j < n_kt; ++j) {
    wait_full(j);
    k_descs(j);
    v_descs(j - 1);
    pin(acc);
    pin(p);
    if constexpr (SPLIT) pin(pl);
    wgmma_fence();
    qk(s);
    wgmma_commit();
    pv(acc, p, pl);
    wgmma_commit();
    wgmma_wait<1>();  // S(j) is ready; P(j-1).V(j-1) may still run
    pin(s);
    if (j == n_kt - 1 && tail < kBlockK) softmax_tile<true>(s, mr, l, al, c, tail, t4);
    else softmax_tile<false>(s, mr, l, al, c, kBlockK, t4);
    wgmma_wait<0>();
    pin(acc);
    pin(p);
    if constexpr (SPLIT) pin(pl);
    if (lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] *= al[(i >> 1) & 1];
    pack();
  }
  v_descs(n_kt - 1);
  pin(acc);
  pin(p);
  if constexpr (SPLIT) pin(pl);
  wgmma_fence();
  pv(acc, p, pl);
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);

  // ---- out = bf16(acc / l), written strided into (B, Nq, H*dh)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long cols = (long long)heads * dh;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const float il[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nq) continue;
    __nv_bfloat16* orow = o + ((long long)b * nq + row) * cols + col0;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * il[r], acc[4 * j + 2 * r + 1] * il[r]);
    }
    if (STATS && t4 == 0) {  // the quad's four lanes hold the same m and l
      m_out[(long long)bh * nq + row] = mr[r] * scale;
      l_out[(long long)bh * nq + row] = l[r];
    }
  }
}

// ---- host side (tensor maps: hopper.cuh)

template <int DHP, int NC, bool STATS, bool SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int b, int nq, int nk,
           int heads, int dh, float scale, cudaStream_t stream) {
  if (const cudaError_t err = bind_device(q); err != cudaSuccess) return static_cast<int>(err);
  const int cols = heads * dh;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, nq, cols, 64 * NC) || !tensor_map(&tk, k, b, nk, cols, kBlockK) ||
      !tensor_map(&tv, v, b, nk, cols, kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kSmemBytes<DHP, NC>;
  static const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DHP, NC, STATS, SPLIT>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((nq + 64 * NC - 1) / (64 * NC), b * heads);
  flash_fwd_bf16_kernel<DHP, NC, STATS, SPLIT><<<grid, kThreads<DHP, NC>, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), m, l, nq, nk, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

// Three consumer warpgroups and the producer warp are 13 warps, which ptxas
// caps at 128 registers a thread; at dh 80 the SPLIT form spills there, so
// it is built with two (168 registers). dh 160 is built with two only: three
// and a producer warpgroup leave 160 registers a consumer, below its 80-register
// output and the rest.
template <int DHP, bool SPLIT>
constexpr bool kBuilt3 = !(SPLIT && DHP == 80) && !kWide<DHP>;

template <int DHP, bool STATS, bool SPLIT>
int by_consumers(int consumers, const void* q, const void* k, const void* v, void* o, float* m, float* l, int b,
                 int nq, int nk, int heads, int dh, float scale, cudaStream_t st) {
  if (consumers == 2) return launch<DHP, 2, STATS, SPLIT>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
  if constexpr (kBuilt3<DHP, SPLIT>)
    if (consumers == 3) return launch<DHP, 3, STATS, SPLIT>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool STATS, bool SPLIT>
int dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int b, int nq, int nk,
             int heads, int dh, float scale, int consumers, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh % 8 != 0 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((dh + 15) / 16 * 16) {
    case 16: return by_consumers<16, STATS, SPLIT>(consumers, q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    case 48: return by_consumers<48, STATS, SPLIT>(consumers, q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    case 80: return by_consumers<80, STATS, SPLIT>(consumers, q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    case 160: return by_consumers<160, STATS, SPLIT>(consumers, q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (b, nq, heads * dh); k, v: (b, nk, heads * dh); bf16, contiguous,
// 16-byte aligned; dh a multiple of 8 that pads to 16, 48, 80 or 160 (the
// UNet's ds1 dh = 40, ds2 dh = 80 and ds4 dh = 160, and small widths for the
// tests); `consumers` 2 or 3: 128 or 192 query rows per CTA (2 only for K6
// and K7 at dh 80, and for every form at dh 160).
// Each returns cudaGetLastError() after the launch.

// K1: P rounded to bf16 before P.V.
extern "C" int vface_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b, int nq,
                                          int nk, int heads, int dh, float scale, int consumers, void* stream) {
  return dispatch<false, false>(q, k, v, o, nullptr, nullptr, b, nq, nk, heads, dh, scale, consumers, stream);
}

// K4: K1 that also writes m, l: (b * heads, nq) fp32, each row's final
// running max (of the scaled scores) and softmax denominator.
extern "C" int vface_flash_attention_stats_bf16(const void* q, const void* k, const void* v, void* o, void* m,
                                                void* l, int b, int nq, int nk, int heads, int dh, float scale,
                                                int consumers, void* stream) {
  return dispatch<true, false>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), b, nq, nk, heads, dh,
                               scale, consumers, stream);
}

// K6: P kept at fp32 precision in P.V (hi + lo).
extern "C" int vface_flash_attention_fp32p_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                                int nq, int nk, int heads, int dh, float scale, int consumers,
                                                void* stream) {
  return dispatch<false, true>(q, k, v, o, nullptr, nullptr, b, nq, nk, heads, dh, scale, consumers, stream);
}

// K7 at bf16: K6 that also writes m and l, its output K6's bit for bit.
extern "C" int vface_flash_attention_fp32p_stats_bf16(const void* q, const void* k, const void* v, void* o,
                                                      void* m, void* l, int b, int nq, int nk, int heads, int dh,
                                                      float scale, int consumers, void* stream) {
  return dispatch<true, true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), b, nq, nk, heads, dh,
                              scale, consumers, stream);
}

// Dynamic shared memory of the instantiation that takes head width dh with
// `consumers` warpgroups, in bytes (0 if none does).
extern "C" int vface_flash_attention_smem_bytes(int dh, int consumers) {
  const int dhp = (dh + 15) / 16 * 16;
  if (consumers != 2 && consumers != 3) return 0;
  switch (dhp) {
    case 16: return consumers == 2 ? kSmemBytes<16, 2> : kSmemBytes<16, 3>;
    case 48: return consumers == 2 ? kSmemBytes<48, 2> : kSmemBytes<48, 3>;
    case 80: return consumers == 2 ? kSmemBytes<80, 2> : kSmemBytes<80, 3>;
    case 160: return consumers == 2 ? kSmemBytes<160, 2> : 0;
    default: return 0;
  }
}
