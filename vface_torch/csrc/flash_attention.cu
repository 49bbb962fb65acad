// Flash self-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces vface_tpu/ops/pallas_attention.py::flash_attention_v5
// (_flash_kernel_v5 via _flash_v5_impl): multi-head attention on (B, N, H*dh)
// with s = (q . k^T) in fp32 times dh^-0.5, an online softmax whose running max
// m and sum l stay in fp32, P rounded to bf16 before the P.V product, fp32
// accumulation, and out = bf16(acc / l).
//
// What bounds it on the H100: the UNet's self-attention sites (N = 4096 with
// dh = 40, N = 1024 with dh = 80) do 4*N*dh FLOPs for every 2*dh*3 bytes of
// q/k/v per token and head, so the work is tensor-core bound. The design keeps
// S and P out of device memory: one CTA of 4 warps owns one (batch*head,
// 64-row q tile), keeps its Q fragments in registers, and walks over 64-row K/V
// tiles staged in shared memory. Both products run on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators); the S accumulator
// fragment is re-packed in registers as the A operand of P.V, so P never
// touches shared memory. Heads are read strided straight out of (B, N, H*dh):
// no split-heads copy on either side. dh is zero-padded in shared memory to
// the next multiple of 16 (the MMA k-step): dh = 40 runs as 48, dh = 80 as 80.
// A ragged N is masked (keys to -inf, rows not stored).
//
// Later work: wgmma and TMA, double-buffered K/V tiles, exp2 with a folded
// scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // q rows per CTA (16 per warp)
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kThreads = 128; // 4 warps

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// DHP: dh padded to a multiple of 16. Q and K tiles are stored row-major
// [row][dh] with a row stride of DHP + 8 elements (16 bytes of padding to
// spread the fragment loads over the banks); V is stored transposed
// [dh][key] so that the B fragment of P.V is one 32-bit load per register.
template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      int n, int heads, int dh, float scale) {
  constexpr int QS = DHP + 8;
  constexpr int VS = kBlockK + 8;
  constexpr int KC = DHP / 16;  // k-steps of Q.K^T
  constexpr int DT = DHP / 8;   // n8 tiles of the output
  constexpr int VEC = DHP / 8;  // 16-byte vectors per padded row
  __shared__ __align__(16) __nv_bfloat16 sq[kBlockQ * QS];
  __shared__ __align__(16) __nv_bfloat16 sk[kBlockK * QS];
  __shared__ __align__(16) __nv_bfloat16 svt[DHP * VS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const long long tok = (long long)heads * dh;  // elements between tokens
  const long long head_off = (long long)b * n * tok + (long long)h * dh;
  const int vec_dh = dh / 8;  // valid 16-byte vectors per head row

  // ---- stage the Q tile, zero-padded in rows (ragged N) and in dh
  for (int idx = tid; idx < kBlockQ * VEC; idx += kThreads) {
    const int r = idx / VEC, c = idx - r * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n && c < vec_dh)
      val = *reinterpret_cast<const uint4*>(q + head_off + (long long)(q0 + r) * tok + c * 8);
    *reinterpret_cast<uint4*>(sq + r * QS + c * 8) = val;
  }
  __syncthreads();

  // this warp's 16 q rows as A fragments, kept in registers for the whole loop
  const int wr = warp * 16;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* p = sq + (wr + g) * QS + kc * 16 + t4 * 2;
    qf[kc][0] = ld_u32(p);
    qf[kc][1] = ld_u32(p + 8 * QS);
    qf[kc][2] = ld_u32(p + 8);
    qf[kc][3] = ld_u32(p + 8 * QS + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // rows g and g + 8 of this warp's tile
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_kt = (n + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * VEC; idx += kThreads) {
      const int r = idx / VEC, c = idx - r * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n && c < vec_dh) {
        const long long off = head_off + (long long)(k0 + r) * tok + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sk + r * QS + c * 8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[(c * 8 + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // ---- S = Q K^T for 16 rows x 64 keys: 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* p = sk + (j * 8 + g) * QS + kc * 16 + t4 * 2;
        mma_bf16_16816(s[j], qf[kc], ld_u32(p), ld_u32(p + 8));
      }
    }

    // ---- scale, mask the ragged tail, online softmax in fp32
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

    // ---- acc += bf16(P) V: the S fragments become A fragments in registers
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* p = svt + (d * 8 + g) * VS + kc * 16 + t4 * 2;
        mma_bf16_16816(acc[d], pa, ld_u32(p), ld_u32(p + 8));
      }
    }
  }

  // ---- out = bf16(acc / l), written strided into (B, N, H*dh)
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + t4 * 2;
    if (col < dh) {
      if (r0 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + head_off + (long long)r0 * tok + col) =
            __floats2bfloat162_rn(acc[d][0] * il0, acc[d][1] * il0);
      if (r1 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + head_off + (long long)r1 * tok + col) =
            __floats2bfloat162_rn(acc[d][2] * il1, acc[d][3] * il1);
    }
  }
}

template <int DHP>
void launch(const void* q, const void* k, const void* v, void* o, int b, int n,
            int heads, int dh, float scale, cudaStream_t stream) {
  dim3 grid((n + kBlockQ - 1) / kBlockQ, b * heads);
  flash_fwd_bf16_kernel<DHP><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, heads,
      dh, scale);
}

}  // namespace

// q, k, v, o: (b, n, heads * dh) bf16, contiguous, 16-byte aligned; dh a
// multiple of 8 that pads to 16, 48 or 80 (the UNet's ds1 dh = 40 and ds2
// dh = 80, and a small width for the tests). Returns cudaGetLastError() after
// the launch.
extern "C" int vface_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, int b, int n, int heads, int dh,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch ((dh + 15) / 16 * 16) {
    case 16: launch<16>(q, k, v, o, b, n, heads, dh, scale, st); break;
    case 48: launch<48>(q, k, v, o, b, n, heads, dh, scale, st); break;
    case 80: launch<80>(q, k, v, o, b, n, heads, dh, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
