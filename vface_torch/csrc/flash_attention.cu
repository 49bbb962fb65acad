// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out: K1 and K4.
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
// * One CTA owns 192 query rows of one (batch, head): three consumer
//   warpgroups of 64 rows share each K/V tile, a third of the L2 traffic of
//   64-row tiles. A producer warp keeps a ring of 4 K/V stages filled by TMA,
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
// columns (32 bytes) by 64 or 192 rows and lands with TMA's 32-byte swizzle,
// which is the wgmma operand layout of that swizzle for both majors: 16
// columns are one k16 step of Q.K^T and 16 output columns of P.V. dh is padded
// to 16/48/80 in shared memory: a padded head's box reads the next head's
// first columns (zeros past the last head, and past N, which TMA fills), so
// the kernel zeroes Q's padding columns; K's then multiply zeros (the inputs
// are finite), and V's land only in output columns that are not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 3;                    // consumer warpgroups, 64 q rows each
constexpr int kBlockQ = 64 * kConsumers;         // q rows per CTA
constexpr int kBlockK = 64;                      // keys per K/V tile: the softmax block
constexpr int kStages = 4;                       // K/V tiles in flight
constexpr int kThreads = 128 * kConsumers + 32;  // the consumers and one producer warp
constexpr int kAtom = 16;                        // columns per 32-byte swizzle row

// [column block][row][16 columns]; TMA swaps the two 16-byte halves of rows
// 4-7 of every 8 (32-byte swizzle: address bit 4 ^= bit 7)
template <int DHP>
struct Smem {
  __nv_bfloat16 q[DHP / kAtom][kBlockQ][kAtom];
  __nv_bfloat16 k[kStages][DHP / kAtom][kBlockK][kAtom];
  __nv_bfloat16 v[kStages][DHP / kAtom][kBlockK][kAtom];
  uint64_t q_full, full[kStages], empty[kStages];
};
template <int DHP>
constexpr int kSmemBytes = sizeof(Smem<DHP>) + 1024;  // + the slack to align it to 1024 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. try_wait may suspend the
// thread for a while, sparing the issue slots. A lost arrival traps after
// ~4 s, failing the launch, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// one box of a 3-D tensor map (column, row, batch) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor, 32-byte swizzle. lbo and sbo in
// bytes: K-major (Q, K) sbo = 256 between 8-row groups, lbo unused; MN-major
// (V) lbo between 16-column blocks, sbo = 256 between 8-key groups.
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(3) << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that a wgmma group reads or writes. Pinned before the group's
// wgmma.fence, their definitions cannot sink into the group; pinned after a
// wait, reads cannot rise above it and the registers are not reused while the
// group runs.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint64_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(r[i])::"memory");
}

// d += A . B^T, m64n64k16: A and B from shared memory, both K-major; `one` is
// a register holding 1, the accumulate flag
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(one));
}

// d = A . B^T, m64n64k16, the accumulators' old values unread: A and B from
// shared memory, both K-major; `zero` is a register holding 0
__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32], uint64_t da, uint64_t db, uint32_t zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(zero));
}

// d += A . B, m64n16k16: A (bf16 pairs) from registers, B from shared memory, MN-major; `one` holds 1
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t db, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
}

// d += A . B, m64n48k16: A (bf16 pairs) from registers, B from shared memory, MN-major; `one` holds 1
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t* a, uint64_t db, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
}

// d += A . B, m64n80k16: A (bf16 pairs) from registers, B from shared memory, MN-major; `one` holds 1
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t* a, uint64_t db, uint32_t one) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
}

template <int DHP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DHP / 2], const uint32_t* a, uint64_t db, uint32_t one) {
  if constexpr (DHP == 16) wgmma_rs_n16(d, a, db, one);
  else if constexpr (DHP == 48) wgmma_rs_n48(d, a, db, one);
  else wgmma_rs_n80(d, a, db, one);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// One 64-key tile of the online softmax for this thread's rows g and g + 8
// (r = 0, 1). s holds the raw scores q.k in the m64n64 accumulator layout
// (s[4j + e]: row g + 8*(e >> 1), key 8j + 2*t4 + (e & 1)); with MASK, keys
// from `valid` on are dropped. Replaces s by P = exp(scale*s - m), updates
// the running raw row maxima mr and this thread's partial sums l, and
// returns the rescale factors al. Packed to bf16 pairs, P is the A operand of
// P.V as it stands: pairs 8kc..8kc+7 hold keys 16kc..16kc+15.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&mr)[2], float (&l)[2], float (&al)[2],
                                             float c, int valid, int t4) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i >> 2) + 2 * t4 + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {mr[0], mr[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    al[r] = ex2((mr[r] - mx[r]) * c);  // 0 on the first tile (mr = -inf)
    mr[r] = mx[r];
  }
  const float mc[2] = {mx[0] * c, mx[1] * c};
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    ls[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + ls[r];
}

template <int DHP, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int nq, int nk, int heads, int dh,
                      float scale) {
  constexpr int NB = DHP / kAtom;  // 16-column blocks: k16 steps of Q.K^T
  extern __shared__ uint8_t smem_raw[];
  Smem<DHP>& sm = *reinterpret_cast<Smem<DHP>*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_kt = (nk + kBlockK - 1) / kBlockK;
  const int col0 = h * dh;
  const int active = min(kConsumers, (nq - q0 + 63) / 64);  // warpgroups with a row below nq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * active);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {  // the producer warp: one thread issues every load
    if (tid == 128 * kConsumers) {
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

  const int wg = tid >> 7;
  if (wg >= active) return;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  mbar_wait(&sm.q_full, 0);
  __syncwarp();
  if (dh < DHP) {  // zero Q's padding columns of this warpgroup's rows
    for (int i = tid & 127; i < 64 * (DHP - dh) / 8; i += 128) {
      const int r = wg * 64 + (i & 63), col = dh + 8 * (i >> 6);
      const int half = ((col & 15) >> 3) ^ ((r >> 2) & 1);
      *reinterpret_cast<uint4*>(&sm.q[col / kAtom][r][8 * half]) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  auto wait_full = [&](int j) {
    mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    __syncwarp();
  };

  // Descriptors in 16-byte units: Q's k16 steps are its column blocks, as are
  // K's; V's k16 steps are 16 keys (512 bytes), its 16-column blocks kBlockK *
  // 32 bytes apart. Every operand register of a wgmma group (descriptors, the
  // accumulate flag, P, the accumulators) is defined before the group's
  // wgmma.fence and pinned there: ptxas serializes all wgmmas of the kernel if
  // an instruction defines one inside a group.
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
  auto pv = [&](float (&acc)[DHP / 2], const uint32_t (&p)[16]) {  // acc += P.V
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_pv<DHP>(acc, &p[4 * kc], dv[kc], one);
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
  uint32_t p[16];
  auto pack = [&] {
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
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
    wgmma_fence();
    qk(s);
    wgmma_commit();
    pv(acc, p);
    wgmma_commit();
    wgmma_wait<1>();  // S(j) is ready; P(j-1).V(j-1) may still run
    pin(s);
    if (j == n_kt - 1 && tail < kBlockK) softmax_tile<true>(s, mr, l, al, c, tail, t4);
    else softmax_tile<false>(s, mr, l, al, c, kBlockK, t4);
    wgmma_wait<0>();
    pin(acc);
    pin(p);
    if (lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] *= al[(i >> 1) & 1];
    pack();
  }
  v_descs(n_kt - 1);
  pin(acc);
  pin(p);
  wgmma_fence();
  pv(acc, p);
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

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time so that nothing links libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// (b, n, cols) bf16 as a tensor map of boxes of 16 columns x `rows` rows x 1,
// 32-byte swizzle; columns past `cols` and rows past n read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int b, int n, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)n * cols * 2};
  const cuuint32_t box[3] = {kAtom, (cuuint32_t)rows, 1}, elem[3] = {1, 1, 1};
  return encode && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP, bool STATS>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int b, int nq, int nk,
           int heads, int dh, float scale, cudaStream_t stream) {
  const int cols = heads * dh;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, nq, cols, kBlockQ) || !tensor_map(&tk, k, b, nk, cols, kBlockK) ||
      !tensor_map(&tv, v, b, nk, cols, kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kSmemBytes<DHP>;
  static const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DHP, STATS>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((nq + kBlockQ - 1) / kBlockQ, b * heads);
  flash_fwd_bf16_kernel<DHP, STATS><<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), m, l, nq, nk, heads, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int b, int nq, int nk,
             int heads, int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh % 8 != 0 || nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((dh + 15) / 16 * 16) {
    case 16: return launch<16, STATS>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    case 48: return launch<48, STATS>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    case 80: return launch<80, STATS>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (b, nq, heads * dh); k, v: (b, nk, heads * dh); bf16, contiguous,
// 16-byte aligned; dh a multiple of 8 that pads to 16, 48 or 80 (the UNet's
// ds1 dh = 40 and ds2 dh = 80, and small widths for the tests). Returns
// cudaGetLastError() after the launch.
extern "C" int vface_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b, int nq,
                                          int nk, int heads, int dh, float scale, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, b, nq, nk, heads, dh, scale, stream);
}

// As above, and m, l: (b * heads, nq) fp32, each row's final running max (of
// the scaled scores) and softmax denominator.
extern "C" int vface_flash_attention_stats_bf16(const void* q, const void* k, const void* v, void* o, void* m,
                                                void* l, int b, int nq, int nk, int heads, int dh, float scale,
                                                void* stream) {
  return dispatch<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), b, nq, nk, heads, dh, scale,
                        stream);
}

// Dynamic shared memory of the instantiation that takes head width dh, in
// bytes (0 if none does).
extern "C" int vface_flash_attention_smem_bytes(int dh) {
  switch ((dh + 15) / 16 * 16) {
    case 16: return kSmemBytes<16>;
    case 48: return kSmemBytes<48>;
    case 80: return kSmemBytes<80>;
    default: return 0;
  }
}
