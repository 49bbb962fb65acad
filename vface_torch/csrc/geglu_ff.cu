// Fused GEGLU feed-forward for Hopper (sm_90a), bf16: K2, and K9 for wide C.
//
// Replaces vface_tpu/ops/pallas_ff.py::geglu_ff (_ff_kernel via _pallas_impl):
//
//   gate = bf16(x @ Wg) + bg          (a bf16 add after the bf16 round)
//   g    = bf16(gelu_erf(f32(gate)))
//   a    = bf16(x @ Wa) + ba
//   out  = bf16((a * g) @ Wo) + bo
//
// with Wa = proj rows [0, I), Wg = proj rows [I, 2I) in PyTorch's Linear
// layout (proj: (2I, C), proj_out: (C, I)), so every B fragment of the tensor
// core product is one 32-bit load of two consecutive k values.
//
// What bounds it on the H100: at the UNet's ds1/ds2 sites (M = B*4096 with
// C = 320, I = 1280; M = B*1024 with C = 640, I = 2560) the products carry
// 6*M*C*I FLOPs against 4*M*C bytes of x and out, so the fused op is tensor
// core bound; unfused, the (M, 2I) projection and the (M, I) gated product make
// a device-memory round trip that is 4x/8x larger than x itself. The design
// keeps them on chip: one CTA of 8 warps owns a 32-row tile of x (staged once
// in shared memory) and streams the inner dimension in 128-wide chunks. Per
// chunk the gate and A products run first on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators), the erf-GELU epilogue runs in fp32 registers,
// and the bf16 a*g chunk goes to shared memory; the chunk's product with Wo
// then accumulates into fp32 registers, each warp owning C/8 output columns.
// The (M, I) intermediate never reaches device memory. Weights are read
// through the L1/L2 caches by every CTA (they are 0.8 and 3.3 MB).
//
// K9, the wide sites. Also replaces vface_tpu/ops/pallas_ff.py::
// _pallas_impl_wide (_ff_kernel_wide): the same function at C > 768, with the
// second product accumulated in fp32 across inner blocks and rounded once,
// which is what the kernel above does for every C (so K9 equals K2 up to fp32
// summation order). The TPU kernel blocks the inner dimension because the
// weights (3*C*4C bf16: 39 MB at C = 1280) do not fit VMEM; here they never
// had to, and what does not carry over is the tile: 8 warps each owning C/8
// output columns over a 32-row tile would need 160 fp32 accumulators per
// thread at C = 1280 and an 82 KB x tile. K9 is the same kernel on 16-row
// tiles (MT = 1): 80 accumulators per thread (C = 1280), a 41 KB x tile, and
// at the ds4 site (M = 3072) 192 CTAs for the 132 SMs. What bounds it: at
// M = 3072, C = 1280, I = 5120 the products are 0.12 ms of tensor-core work,
// but every 16-row CTA re-reads all 39 MB of weights through L2 (7.5 GB in
// all at M = 3072), so L2 bandwidth, not the tensor cores, sets its pace. The
// UNet keeps these sites on the unfused cuBLAS path, as the JAX package does,
// until the card's times say otherwise.
//
// Later work: larger row tiles or a persistent schedule to cut the weight
// re-reads, cp.async/TMA staging of the weight chunks, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIC = 128;       // inner columns per chunk (16 per warp)
constexpr int kThreads = 256;  // 8 warps

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

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16(acc) + bias as a bf16 add: exact in fp32, one rounding to bf16
__device__ __forceinline__ float bf16_add(float acc, __nv_bfloat16 bias) {
  return bf16_round(bf16_round(acc) + __bfloat162float(bias));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// C = 64 * NT: each warp owns NT n8 tiles of the output; a CTA owns MT m16
// row tiles (K2: 32 rows, K9: 16)
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads)
geglu_ff_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wp,
                     const __nv_bfloat16* __restrict__ bp,
                     const __nv_bfloat16* __restrict__ wo,
                     const __nv_bfloat16* __restrict__ bo,
                     __nv_bfloat16* __restrict__ out, int m, int inner) {
  constexpr int C = 64 * NT;
  constexpr int kTM = 16 * MT;
  constexpr int XS = C + 8;    // x tile row stride (elements)
  constexpr int HS = kIC + 8;  // a*g chunk row stride
  constexpr int XV = C / 8;    // 16-byte vectors per x row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = xs + kTM * XS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kTM;

  for (int idx = tid; idx < kTM * XV; idx += kThreads) {
    const int r = idx / XV, c = idx - r * XV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < m)
      val = *reinterpret_cast<const uint4*>(x + (long long)(row0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(xs + r * XS + c * 8) = val;
  }
  __syncthreads();

  float oacc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) oacc[mt][j][0] = oacc[mt][j][1] = oacc[mt][j][2] = oacc[mt][j][3] = 0.f;
  const int ocol0 = warp * (C / 8);

  for (int ch = 0; ch < inner; ch += kIC) {
    // ---- gate and A products for this warp's 16 inner columns of the chunk
    const int ic0 = ch + warp * 16;
    float ga[MT][2][4], aa[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[mt][j][e] = aa[mt][j][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = xs + (mt * 16 + g) * XS + kc * 16 + t4 * 2;
        af[mt][0] = ld_u32(p);
        af[mt][1] = ld_u32(p + 8 * XS);
        af[mt][2] = ld_u32(p + 8);
        af[mt][3] = ld_u32(p + 8 * XS + 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* wa = wp + (long long)(ic0 + j * 8 + g) * C + kc * 16 + t4 * 2;
        const __nv_bfloat16* wg = wa + (long long)inner * C;
        const uint32_t bg0 = ldg_u32(wg), bg1 = ldg_u32(wg + 8);
        const uint32_t ba0 = ldg_u32(wa), ba1 = ldg_u32(wa + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(ga[mt][j], af[mt], bg0, bg1);
          mma_bf16_16816(aa[mt][j], af[mt], ba0, ba1);
        }
      }
    }
    // ---- fp32 erf-GELU epilogue in registers; bf16 a*g chunk to shared memory
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = warp * 16 + j * 8 + t4 * 2;  // column within the chunk
      const int icol = ch + col;
      const __nv_bfloat16 bgt0 = bp[inner + icol], bgt1 = bp[inner + icol + 1];
      const __nv_bfloat16 bav0 = bp[icol], bav1 = bp[icol + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = mt * 16 + g + half * 8;
          const float g0 = bf16_round(gelu_erf(bf16_add(ga[mt][j][2 * half], bgt0)));
          const float g1 = bf16_round(gelu_erf(bf16_add(ga[mt][j][2 * half + 1], bgt1)));
          const float a0 = bf16_add(aa[mt][j][2 * half], bav0);
          const float a1 = bf16_add(aa[mt][j][2 * half + 1], bav1);
          *reinterpret_cast<__nv_bfloat162*>(hs + row * HS + col) =
              __floats2bfloat162_rn(a0 * g0, a1 * g1);
        }
      }
    }
    __syncthreads();
    // ---- out += (a*g chunk) @ Wo[chunk, :] for this warp's C/8 columns
#pragma unroll
    for (int kc = 0; kc < kIC / 16; ++kc) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = hs + (mt * 16 + g) * HS + kc * 16 + t4 * 2;
        af[mt][0] = ld_u32(p);
        af[mt][1] = ld_u32(p + 8 * HS);
        af[mt][2] = ld_u32(p + 8);
        af[mt][3] = ld_u32(p + 8 * HS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* w = wo + (long long)(ocol0 + j * 8 + g) * inner + ch + kc * 16 + t4 * 2;
        const uint32_t b0 = ldg_u32(w), b1 = ldg_u32(w + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(oacc[mt][j], af[mt], b0, b1);
      }
    }
    __syncthreads();  // the chunk buffer is rewritten next iteration
  }

  // ---- out = bf16(acc) + bo, a bf16 add
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = ocol0 + j * 8 + t4 * 2;
    const __nv_bfloat16 b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + g + half * 8;
        if (row < m)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * C + col) =
              __floats2bfloat162_rn(bf16_add(oacc[mt][j][2 * half], b0),
                                    bf16_add(oacc[mt][j][2 * half + 1], b1));
      }
    }
  }
}

template <int NT, int MT>
int launch(const void* x, const void* wp, const void* bp, const void* wo, const void* bo,
           void* out, int m, int inner, cudaStream_t stream) {
  constexpr int C = 64 * NT;
  constexpr int kTM = 16 * MT;
  const int smem = (kTM * (C + 8) + kTM * (kIC + 8)) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(geglu_ff_bf16_kernel<NT, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (m + kTM - 1) / kTM;
  geglu_ff_bf16_kernel<NT, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bp), static_cast<const __nv_bfloat16*>(wo),
      static_cast<const __nv_bfloat16*>(bo), static_cast<__nv_bfloat16*>(out), m, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, c), wp: (2*inner, c), bp: (2*inner,), wo: (c, inner), bo: (c,), out: (m, c);
// all bf16, contiguous, 16-byte aligned; inner a multiple of 128. Each returns
// cudaGetLastError() after the launch.

// K2: c one of 320 and 640 (the UNet's ds1 and ds2 widths) or 64 (the tests).
extern "C" int vface_geglu_ff_bf16(const void* x, const void* wp, const void* bp,
                                   const void* wo, const void* bo, void* out, int m, int c,
                                   int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inner % kIC != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 64: return launch<1, 2>(x, wp, bp, wo, bo, out, m, inner, st);
    case 320: return launch<5, 2>(x, wp, bp, wo, bo, out, m, inner, st);
    case 640: return launch<10, 2>(x, wp, bp, wo, bo, out, m, inner, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: c 1280 (the UNet's ds4 and middle-block width) or 1024 (the JAX test's).
extern "C" int vface_geglu_ff_wide_bf16(const void* x, const void* wp, const void* bp,
                                        const void* wo, const void* bo, void* out, int m, int c,
                                        int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inner % kIC != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 1024: return launch<16, 1>(x, wp, bp, wo, bo, out, m, inner, st);
    case 1280: return launch<20, 1>(x, wp, bp, wo, bo, out, m, inner, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
