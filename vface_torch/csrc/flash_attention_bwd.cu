// Flash self-attention for training on Hopper (sm_90a): the fp32-P forward
// that the backward recomputes (K6), its stats instantiation (K7) and the two
// backward kernels (K5).
//
// Replaces, in vface_tpu/ops/pallas_attention.py:
//   * _flash_v2_impl (_flash_kernel_v2): attention with fp32 operands, P not
//     rounded, out = (sum_j exp(s - m) v_j) / l rounded once to the input
//     dtype. flash_attention_bwd calls it to recompute O for D = rowsum(dO*O);
//   * _flash_v2_stats (_flash_kernel_v2_stats), the forward of
//     flash_attention_v2's VJP: the STATS instantiation of the same kernel,
//     which also writes each row's final m and l in fp32 to (B*H, N). Only the
//     epilogue differs, so its output is K6's bit for bit (bf16 operands; the
//     fp32-operand case is K8's kernel with the same epilogue, in
//     flash_attention_f32.cu);
//   * flash_attention_bwd's two kernels, _flash_bwd_dq_kernel (dQ, grid over
//     query tiles, a loop over keys) and _flash_bwd_dkv_kernel (dK and dV,
//     grid over key tiles, a loop over queries). Both recompute
//     P = exp(s * scale - m) / l from the forward's row statistics and form
//     dS = P * (dP - D) with dP = dO . V^T; dQ = scale * dS . K,
//     dK = scale * dS^T . Q, dV = P^T . dO, each rounded once to bf16.
//     P and dS never touch device memory.
//
// Precision. In the UNet q, k, v and dO are bf16 values, so S = Q K^T and
// dP = dO V^T run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 accumulators) as exact products; only the summation order differs from
// the TPU kernels' fp32 dots. P and dS are fp32 values and are NOT rounded to
// bf16 alone (FlashAttention-2 does; the TPU kernels do not): each is split
// into x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), and its product
// with the exact bf16 operand runs as two mma.sync into one fp32
// accumulator. The pair carries about 16 significant bits, so each product
// term is good to ~2^-17 relative, far below the one bf16 rounding of the
// result.
//
// What bounds it on the H100: like the forward, the UNet shapes (N = 4096,
// dh = 40; N = 1024, dh = 80) are tensor-core bound (K5 does 5 N^2-products,
// K6 2, against 2-byte operands). This first version keeps one CTA of 4 warps
// per 64-row tile, the streamed operand's tiles in shared memory (row-major
// for the A . B^T products, transposed as they are stored for the products
// that contract over the tile's rows), and the resident tile's fragments and
// the fp32 accumulators in registers. The layout stays (B, N, H*dh) with heads
// read strided: the TPU kernels' transposed (dh, N) layout is a TPU lane
// trick. dh is zero-padded to the MMA k-step (40 -> 48, 80, 16 for tests);
// ragged N is masked. Later work: wgmma, TMA, pipelined tiles, one fused
// kernel with atomics for dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // rows of the resident tile and of each streamed tile
constexpr int kThreads = 128;  // 4 warps, 16 resident rows each
constexpr int kTS = kBlock + 8;  // row stride of a transposed tile (16 bytes of bank padding)

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (a, b) as bf16 pairs hi = bf16(x), lo = bf16(x - hi), packed low half first.
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 r = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

// Stage a 64-row tile of one head, rows [r0, r0 + 64) of (B, N, H*dh), into
// shared memory: row-major [row][DHP + 8] and/or transposed [col][kTS].
// Rows past n and columns past dh are zero.
template <int DHP, bool ROWS, bool TRANS>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src, long long head_off,
                                      long long tok, int r0, int n, int dh,
                                      __nv_bfloat16* rows, __nv_bfloat16* trans, int tid) {
  constexpr int QS = DHP + 8;
  constexpr int VEC = DHP / 8;  // 16-byte vectors per padded row
  const int vec_dh = dh / 8;
  for (int idx = tid; idx < kBlock * VEC; idx += kThreads) {
    const int r = idx / VEC, c = idx - r * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c < vec_dh)
      val = *reinterpret_cast<const uint4*>(src + head_off + (long long)(r0 + r) * tok + c * 8);
    if (ROWS) *reinterpret_cast<uint4*>(rows + r * QS + c * 8) = val;
    if (TRANS) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) trans[(c * 8 + j) * kTS + r] = e[j];
    }
  }
}

// A fragments of this warp's 16 rows (from row wr) of a row-major tile.
template <int DHP>
__device__ __forceinline__ void load_a(const __nv_bfloat16* rows, int wr, int g, int t4,
                                       uint32_t (&f)[DHP / 16][4]) {
  constexpr int QS = DHP + 8;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc) {
    const __nv_bfloat16* p = rows + (wr + g) * QS + kc * 16 + t4 * 2;
    f[kc][0] = ld_u32(p);
    f[kc][1] = ld_u32(p + 8 * QS);
    f[kc][2] = ld_u32(p + 8);
    f[kc][3] = ld_u32(p + 8 * QS + 8);
  }
}

// acc (16 x 64) = A . T^T: A the warp's 16 x DHP fragments, T a row-major
// [64][DHP + 8] tile. Exact bf16 products, fp32 sums.
template <int DHP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], uint32_t (&a)[DHP / 16][4],
                                        const __nv_bfloat16* tile, int g, int t4) {
  constexpr int QS = DHP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DHP / 16; ++kc) {
      const __nv_bfloat16* p = tile + (j * 8 + g) * QS + kc * 16 + t4 * 2;
      mma_bf16_16816(acc[j], a[kc], ld_u32(p), ld_u32(p + 8));
    }
  }
}

// acc (16 x DHP) += X . T: X the warp's 16 x 64 fp32 values in accumulator
// layout, split hi + lo into A fragments; T a transposed [DHP][kTS] tile.
template <int DHP>
__device__ __forceinline__ void mma_split_xt(float (&acc)[DHP / 8][4], float (&x)[8][4],
                                             const __nv_bfloat16* trans, int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < kBlock / 16; ++kc) {
    uint32_t hi[4], lo[4];
    split_pack(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0]);
    split_pack(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1]);
    split_pack(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2]);
    split_pack(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int d = 0; d < DHP / 8; ++d) {
      const __nv_bfloat16* p = trans + (d * 8 + g) * kTS + kc * 16 + t4 * 2;
      const uint32_t b0 = ld_u32(p), b1 = ld_u32(p + 8);
      mma_bf16_16816(acc[d], hi, b0, b1);
      mma_bf16_16816(acc[d], lo, b0, b1);
    }
  }
}

// Store acc * mul (rows r0 = row g, r1 = row g + 8 of the warp) as bf16, strided.
template <int DHP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, long long head_off,
                                           long long tok, int r0, int n, int dh,
                                           float (&acc)[DHP / 8][4], float mul0, float mul1,
                                           int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int d = 0; d < DHP / 8; ++d) {
    const int col = d * 8 + t4 * 2;
    if (col < dh) {
      if (r0 < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (long long)r0 * tok + col) =
            __floats2bfloat162_rn(acc[d][0] * mul0, acc[d][1] * mul0);
      if (r1 < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (long long)r1 * tok + col) =
            __floats2bfloat162_rn(acc[d][2] * mul1, acc[d][3] * mul1);
    }
  }
}

// ---- K6: forward with P kept at fp32 precision in P.V; STATS (K7) also
// writes each row's final m and l, leaving the output bit for bit as it is
template <int DHP, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32p_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out, int n, int heads,
                       int dh, float scale) {
  constexpr int QS = DHP + 8;
  constexpr int DT = DHP / 8;
  __shared__ __align__(16) __nv_bfloat16 sk[kBlock * QS];  // Q, then each K tile
  __shared__ __align__(16) __nv_bfloat16 svt[DHP * kTS];   // V^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBlock, wr = warp * 16;
  const long long tok = (long long)heads * dh;
  const long long head_off = (long long)b * n * tok + (long long)h * dh;

  stage<DHP, true, false>(q, head_off, tok, q0, n, dh, sk, nullptr, tid);
  __syncthreads();
  uint32_t qf[DHP / 16][4];
  load_a<DHP>(sk, wr, g, t4, qf);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlock) {
    __syncthreads();  // Q fragments loaded / the previous tile consumed
    stage<DHP, true, false>(k, head_off, tok, k0, n, dh, sk, nullptr, tid);
    stage<DHP, false, true>(v, head_off, tok, k0, n, dh, nullptr, svt, tid);
    __syncthreads();
    float s[8][4];
    mma_abt<DHP>(s, qf, sk, g, t4);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = key < n ? s[j][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
    l0 = al0 * l0 + ls0;
    l1 = al1 * l1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= al0;
      acc[d][1] *= al0;
      acc[d][2] *= al1;
      acc[d][3] *= al1;
    }
    mma_split_xt<DHP>(acc, s, svt, g, t4);  // acc += P V, P at fp32 precision
  }
  // out = bf16(acc / l), the TPU kernel's division
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] /= l0;
    acc[d][1] /= l0;
    acc[d][2] /= l1;
    acc[d][3] /= l1;
  }
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  store_rows<DHP>(o, head_off, tok, r0, n, dh, acc, 1.f, 1.f, t4);
  if (STATS && t4 == 0) {  // the quad's four lanes hold the same m and l
    const long long st = (long long)bh * n;
    if (r0 < n) {
      m_out[st + r0] = m0;
      l_out[st + r0] = l0;
    }
    if (r1 < n) {
      m_out[st + r1] = m1;
      l_out[st + r1] = l1;
    }
  }
}

// ---- K5 part 1: dQ for one 64-row query tile, looping over key tiles
template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq, int n,
                    int heads, int dh, float scale) {
  constexpr int QS = DHP + 8;
  constexpr int DT = DHP / 8;
  __shared__ __align__(16) __nv_bfloat16 sa[kBlock * QS];   // Q, then each K tile
  __shared__ __align__(16) __nv_bfloat16 sb[kBlock * QS];   // dO, then each V tile
  __shared__ __align__(16) __nv_bfloat16 skt[DHP * kTS];    // K^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBlock, wr = warp * 16;
  const long long tok = (long long)heads * dh;
  const long long head_off = (long long)b * n * tok + (long long)h * dh;

  stage<DHP, true, false>(q, head_off, tok, q0, n, dh, sa, nullptr, tid);
  stage<DHP, true, false>(dout, head_off, tok, q0, n, dh, sb, nullptr, tid);
  __syncthreads();
  uint32_t qf[DHP / 16][4], df[DHP / 16][4];
  load_a<DHP>(sa, wr, g, t4, qf);
  load_a<DHP>(sb, wr, g, t4, df);

  // this thread's two rows: statistics, with P = 0 on rows past n (m = +inf)
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const long long st = (long long)bh * n;
  const float m0 = r0 < n ? m[st + r0] : INFINITY, m1 = r1 < n ? m[st + r1] : INFINITY;
  const float l0 = r0 < n ? l[st + r0] : 1.f, l1 = r1 < n ? l[st + r1] : 1.f;
  const float d0 = r0 < n ? dd[st + r0] : 0.f, d1 = r1 < n ? dd[st + r1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlock) {
    __syncthreads();
    stage<DHP, true, true>(k, head_off, tok, k0, n, dh, sa, skt, tid);
    stage<DHP, true, false>(v, head_off, tok, k0, n, dh, sb, nullptr, tid);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<DHP>(s, qf, sa, g, t4);   // S = Q K^T
    mma_abt<DHP>(dp, df, sb, g, t4);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        const float mr = e < 2 ? m0 : m1, lr = e < 2 ? l0 : l1, dr = e < 2 ? d0 : d1;
        const float p = key < n ? expf(s[j][e] * scale - mr) / lr : 0.f;
        s[j][e] = p * (dp[j][e] - dr);  // dS
      }
    }
    mma_split_xt<DHP>(acc, s, skt, g, t4);  // dQ += dS K
  }
  store_rows<DHP>(dq, head_off, tok, r0, n, dh, acc, scale, scale, t4);
}

// ---- K5 part 2: dK and dV for one 64-row key tile, looping over query tiles
template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int n, int heads, int dh, float scale) {
  constexpr int QS = DHP + 8;
  constexpr int DT = DHP / 8;
  __shared__ __align__(16) __nv_bfloat16 sa[kBlock * QS];    // K, then each Q tile
  __shared__ __align__(16) __nv_bfloat16 sb[kBlock * QS];    // V, then each dO tile
  __shared__ __align__(16) __nv_bfloat16 sqt[DHP * kTS];     // Q^T
  __shared__ __align__(16) __nv_bfloat16 sdot[DHP * kTS];    // dO^T
  __shared__ float sm[kBlock], sl[kBlock], sd[kBlock];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kBlock, wr = warp * 16;
  const long long tok = (long long)heads * dh;
  const long long head_off = (long long)b * n * tok + (long long)h * dh;
  const long long st = (long long)bh * n;

  stage<DHP, true, false>(k, head_off, tok, k0, n, dh, sa, nullptr, tid);
  stage<DHP, true, false>(v, head_off, tok, k0, n, dh, sb, nullptr, tid);
  __syncthreads();
  uint32_t kf[DHP / 16][4], vf[DHP / 16][4];
  load_a<DHP>(sa, wr, g, t4, kf);
  load_a<DHP>(sb, wr, g, t4, vf);

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc_k[d][0] = acc_k[d][1] = acc_k[d][2] = acc_k[d][3] = 0.f;
    acc_v[d][0] = acc_v[d][1] = acc_v[d][2] = acc_v[d][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBlock) {
    __syncthreads();
    stage<DHP, true, true>(q, head_off, tok, q0, n, dh, sa, sqt, tid);
    stage<DHP, true, true>(dout, head_off, tok, q0, n, dh, sb, sdot, tid);
    for (int i = tid; i < kBlock; i += kThreads) {  // P = 0 on query rows past n
      const int r = q0 + i;
      sm[i] = r < n ? m[st + r] : INFINITY;
      sl[i] = r < n ? l[st + r] : 1.f;
      sd[i] = r < n ? dd[st + r] : 0.f;
    }
    __syncthreads();
    float pt[8][4], dpt[8][4];
    mma_abt<DHP>(pt, kf, sa, g, t4);   // S^T = K Q^T (16 keys x 64 queries)
    mma_abt<DHP>(dpt, vf, sb, g, t4);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + t4 * 2 + (e & 1);
        const float p = expf(pt[j][e] * scale - sm[c]) / sl[c];
        pt[j][e] = p;                          // P^T
        dpt[j][e] = p * (dpt[j][e] - sd[c]);   // dS^T
      }
    }
    mma_split_xt<DHP>(acc_v, pt, sdot, g, t4);  // dV += P^T dO
    mma_split_xt<DHP>(acc_k, dpt, sqt, g, t4);  // dK += dS^T Q
  }
  const int r0 = k0 + wr + g;
  store_rows<DHP>(dk, head_off, tok, r0, n, dh, acc_k, scale, scale, t4);
  store_rows<DHP>(dv, head_off, tok, r0, n, dh, acc_v, 1.f, 1.f, t4);
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *m, *l, *dd;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float *m_out, *l_out;
  int b, n, heads, dh;
  float scale;
};

enum Which { kFwdFp32P, kFwdFp32PStats, kBwdDq, kBwdDkv };

template <int DHP>
void launch(Which which, const Args& a, cudaStream_t stream) {
  dim3 grid((a.n + kBlock - 1) / kBlock, a.b * a.heads);
  switch (which) {
    case kFwdFp32P:
      flash_fwd_fp32p_kernel<DHP, false><<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.o, nullptr, nullptr, a.n, a.heads, a.dh, a.scale);
      break;
    case kFwdFp32PStats:
      flash_fwd_fp32p_kernel<DHP, true><<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.o, a.m_out, a.l_out, a.n, a.heads, a.dh, a.scale);
      break;
    case kBwdDq:
      flash_bwd_dq_kernel<DHP><<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.dout, a.m, a.l, a.dd, a.dq, a.n, a.heads, a.dh, a.scale);
      break;
    case kBwdDkv:
      flash_bwd_dkv_kernel<DHP><<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.dout, a.m, a.l, a.dd, a.dk, a.dv, a.n, a.heads, a.dh, a.scale);
      break;
  }
}

int dispatch(Which which, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.dh % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.dh + 15) / 16 * 16) {
    case 16: launch<16>(which, a, st); break;
    case 48: launch<48>(which, a, st); break;
    case 80: launch<80>(which, a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

Args args(const void* q, const void* k, const void* v, int b, int n, int heads, int dh,
          float scale) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.b = b;
  a.n = n;
  a.heads = heads;
  a.dh = dh;
  a.scale = scale;
  return a;
}

}  // namespace

// Tensors are (b, n, heads * dh) bf16, contiguous and 16-byte aligned; m, l,
// dd are (b * heads, n) fp32; dh a multiple of 8 that pads to 16, 48 or 80.
// Each returns cudaGetLastError() after its launch.

// K6: o = bf16(softmax(q k^T * scale) v) with P at fp32 precision.
extern "C" int vface_flash_attention_fp32p_bf16(const void* q, const void* k, const void* v,
                                                void* o, int b, int n, int heads, int dh,
                                                float scale, void* stream) {
  Args a = args(q, k, v, b, n, heads, dh, scale);
  a.o = static_cast<__nv_bfloat16*>(o);
  return dispatch(kFwdFp32P, a, stream);
}

// K7: K6 that also writes m, l: (b * heads, n) fp32, each row's final running
// max of the scaled scores and softmax denominator; o is K6's bit for bit.
extern "C" int vface_flash_attention_fp32p_stats_bf16(const void* q, const void* k, const void* v,
                                                      void* o, void* m, void* l, int b, int n,
                                                      int heads, int dh, float scale,
                                                      void* stream) {
  Args a = args(q, k, v, b, n, heads, dh, scale);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  return dispatch(kFwdFp32PStats, a, stream);
}

// K5, dQ: m, l from the stats forward, dd = rowsum(dO * O) per head and row.
extern "C" int vface_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                                 const void* dout, const void* m,
                                                 const void* l, const void* dd, void* dq,
                                                 int b, int n, int heads, int dh, float scale,
                                                 void* stream) {
  Args a = args(q, k, v, b, n, heads, dh, scale);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.dd = static_cast<const float*>(dd);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  return dispatch(kBwdDq, a, stream);
}

// K5, dK and dV.
extern "C" int vface_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                  const void* dout, const void* m,
                                                  const void* l, const void* dd, void* dk,
                                                  void* dv, int b, int n, int heads, int dh,
                                                  float scale, void* stream) {
  Args a = args(q, k, v, b, n, heads, dh, scale);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.dd = static_cast<const float*>(dd);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  return dispatch(kBwdDkv, a, stream);
}
