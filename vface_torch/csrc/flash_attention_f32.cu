// Flash attention in full fp32 on the CUDA cores for Hopper (sm_90a): K8.
//
// Replaces vface_tpu/ops/pallas_attention.py::flash_attention (_flash_kernel,
// the k-tiled v1 kernel): multi-head attention over q (B, Nq, H*dh) and k, v
// (B, Nk, H*dh), any input type cast to fp32; s = (q . k^T) in fp32 times
// dh^-0.5; an online softmax over key blocks with fp32 running max m and sum
// l; P kept in fp32 for the fp32 P.V product; out = acc / l, rounded once to
// the input type. Nq != Nk is allowed. For bf16 inputs this is K6's function
// (_flash_v2_impl) computed in fp32 throughout.
//
// The STATS instantiation also writes each query row's final m and l, fp32
// (B*H, Nq): for fp32 operands it is the port's _flash_v2_stats (K7), the
// forward of flash_attention_v2's VJP. Its output is the plain
// instantiation's bit for bit: only the epilogue differs.
//
// What bounds it on the H100: the work is 2 products of 2*Nq*Nk*dh FLOPs per
// head against (Nq + 2*Nk)*dh input values, far above the bytes line, and
// fp32 operands need fp32-accurate S and P.V. The tensor cores give that only
// through multi-term splits (3xTF32, bf16x3), left for later work, so this
// first version is bound by the fp32 FFMA rate of the CUDA cores, 67 TFLOP/s.
//
// Design. One CTA of 8 warps owns one (batch*head, 64-row query tile). Each
// thread owns one query row: q and the fp32 accumulator stay in registers
// (2*dh floats). The 256 threads form 4 key groups of 64 threads (2 warps);
// the CTA stages 64-key K and V tiles in shared memory as fp32, and group g
// takes keys [16g, 16g + 16) of each tile, so every thread of a warp reads the
// same K/V row (a shared-memory broadcast, one 16-byte load feeding 4 FFMAs)
// and 4x as many warps are in flight as rows alone would give. Each group runs
// its own online softmax (expf, not __expf) over its keys; at the end the
// groups' (m, l, acc) are merged through shared memory in a fixed order, so
// the result does not vary from run to run. Heads are read strided out of
// (B, N, H*dh) with 16-byte loads (no split-heads copy); ragged Nq and Nk are
// masked. dh is one of 16, 32, 40 and 80 (the JAX tests' widths and the
// UNet's ds1 and ds2); other widths are refused.
//
// Later work: 3xTF32 or bf16x3 tensor-core products, double-buffered tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;             // query rows per CTA, one per thread of a group
constexpr int kGroups = 4;            // key groups per CTA
constexpr int kThreads = kRows * kGroups;
constexpr int kTile = 64;             // keys per staged K/V tile
constexpr int kKeys = kTile / kGroups;  // keys of each tile per group

// 16 bytes of input as fp32 values: 4 floats or 8 bf16s.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <typename T, int DH, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int nq, int nk, int heads, float scale) {
  using V = Vec<T>;
  constexpr int EV = V::kN;      // input elements per 16-byte vector
  constexpr int VPR = DH / EV;   // vectors per head row
  constexpr int MS = DH + 2;     // floats of one row's partial (acc, m, l) in the merge
  static_assert(DH % 8 == 0 && DH % EV == 0, "dh must be a multiple of 8");
  // K and V tiles [key][DH] fp32; reused for the merge of the groups' partials
  constexpr int TILE_FLOATS = 2 * kTile * DH;
  static_assert(MS * kRows <= TILE_FLOATS, "merge buffer must fit in the tile buffer");
  __shared__ __align__(16) float smem[TILE_FLOATS];
  float* sk = smem;
  float* sv = smem + kTile * DH;

  const int tid = threadIdx.x;
  const int row = tid % kRows, grp = tid / kRows;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q_row = blockIdx.x * kRows + row;
  const long long tok = (long long)heads * DH;  // elements between tokens
  const T* kh = k + (long long)b * nk * tok + (long long)h * DH;
  const T* vh = v + (long long)b * nk * tok + (long long)h * DH;
  const long long q_off = (long long)b * nq * tok + (long long)q_row * tok + (long long)h * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int c = 0; c < VPR; ++c) {
    if (q_row < nq) {
      V::load(q + q_off + c * EV, qr + c * EV);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e) qr[c * EV + e] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kTile * VPR; idx += kThreads) {
      const int r = idx / VPR, c = idx - r * VPR;
      float kv[EV], vv[EV];
      if (k0 + r < nk) {
        const long long off = (long long)(k0 + r) * tok + c * EV;
        V::load(kh + off, kv);
        V::load(vh + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < EV; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EV; e += 4) {
        Vec<float>::store(sk + r * DH + c * EV + e, kv + e);
        Vec<float>::store(sv + r * DH + c * EV + e, vv + e);
      }
    }
    __syncthreads();

    // ---- s = (q . k) * scale for this group's keys of the tile
    const int key0 = grp * kKeys;
    float s[kKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sk + (key0 + j) * DH);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[j] = k0 + key0 + j < nk ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    if (mx == -INFINITY) continue;  // every key of this group's slice lies past nk

    // ---- online softmax in fp32, then acc += P V with P in fp32
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = expf(s[j] - mn);
      ls += s[j];
    }
    l = alpha * l + ls;
    m = mn;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(sv + (key0 + j) * DH);
      const float p = s[j];
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
  }

  // ---- merge groups 1..3 into group 0, one at a time, in a fixed order;
  // the buffer is [MS][kRows] so that a warp's rows are consecutive floats
  for (int g = 1; g < kGroups; ++g) {
    __syncthreads();
    if (grp == g) {
#pragma unroll
      for (int d = 0; d < DH; ++d) smem[d * kRows + row] = acc[d];
      smem[DH * kRows + row] = m;
      smem[(DH + 1) * kRows + row] = l;
    }
    __syncthreads();
    if (grp == 0) {
      const float mg = smem[DH * kRows + row], lg = smem[(DH + 1) * kRows + row];
      const float mn = fmaxf(m, mg);  // finite: group 0 holds key 0
      const float a = expf(m - mn), bg = expf(mg - mn);
      l = a * l + bg * lg;
      m = mn;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = a * acc[d] + bg * smem[d * kRows + row];
    }
  }
  if (grp != 0 || q_row >= nq) return;

  // ---- out = acc / l rounded once to the input type (the TPU kernel's division)
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] /= l;
#pragma unroll
  for (int c = 0; c < VPR; ++c) V::store(o + q_off + c * EV, acc + c * EV);
  if (STATS) {
    m_out[(long long)bh * nq + q_row] = m;
    l_out[(long long)bh * nq + q_row] = l;
  }
}

template <typename T, bool STATS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* m, void* l, int b,
             int nq, int nk, int heads, int dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((nq + kRows - 1) / kRows, b * heads);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  switch (dh) {
    case 16: flash_f32_kernel<T, 16, STATS><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, mm, ll, nq, nk, heads, scale); break;
    case 32: flash_f32_kernel<T, 32, STATS><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, mm, ll, nq, nk, heads, scale); break;
    case 40: flash_f32_kernel<T, 40, STATS><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, mm, ll, nq, nk, heads, scale); break;
    case 80: flash_f32_kernel<T, 80, STATS><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, mm, ll, nq, nk, heads, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (b, nq, heads * dh); k, v: (b, nk, heads * dh); all fp32 (the _f32
// entry points) or all bf16 (the _bf16 ones), contiguous and 16-byte aligned;
// dh one of 16, 32, 40, 80. The _stats entry points also write m, l: (b *
// heads, nq) fp32. Each returns cudaGetLastError() after its launch.
extern "C" int vface_flash_attention_v1_f32(const void* q, const void* k, const void* v, void* o,
                                            int b, int nq, int nk, int heads, int dh,
                                            float scale, void* stream) {
  return dispatch<float, false>(q, k, v, o, nullptr, nullptr, b, nq, nk, heads, dh, scale, stream);
}

extern "C" int vface_flash_attention_v1_bf16(const void* q, const void* k, const void* v, void* o,
                                             int b, int nq, int nk, int heads, int dh,
                                             float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, v, o, nullptr, nullptr, b, nq, nk, heads, dh, scale,
                                        stream);
}

extern "C" int vface_flash_attention_v1_stats_f32(const void* q, const void* k, const void* v,
                                                  void* o, void* m, void* l, int b, int nq, int nk,
                                                  int heads, int dh, float scale, void* stream) {
  return dispatch<float, true>(q, k, v, o, m, l, b, nq, nk, heads, dh, scale, stream);
}
