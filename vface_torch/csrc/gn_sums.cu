// GroupNorm statistics for Hopper (sm_90a): K3.
//
// Replaces vface_tpu/models/layers.py::_gn_sums_pallas (_gn_sums_kernel): the
// fp32 sum and sum of squares of each (batch, channel). The port keeps
// activations NCHW, so each pair is one contiguous row of H*W elements (bf16,
// fp16 or fp32), summed in fp32.
//
// What bounds it on the H100: device-memory bytes (two flops an element read),
// 0.030 ms for the 100 MB of the UNet's VAE at (6,512,128,128) bf16. The TPU
// kernel walked row blocks in order on one core, carrying the sums in a
// resident output block; here one launch streams every row at once:
// * A row of up to 32768 elements takes one CTA; a longer one (the VAE's
//   262,144 and, on the video path's HD frames, 921,600) takes a thread-block
//   cluster of up to 8 CTAs, each summing an even share of the row's 16-byte
//   vectors. Each CTA stores its partial pair into CTA 0's shared memory
//   (distributed shared memory), and after one cluster barrier CTA 0 adds
//   them in rank order, while the others have already left. No second pass,
//   no partial-sum tensor and no atomics: the same inputs give the same bits
//   from launch to launch. The barrier phase that says every CTA of the
//   cluster has started (before any of them writes into CTA 0) is arrived at
//   first thing and waited on after the loads, so it costs no time. On the
//   card this was faster than two full cluster syncs (CTA 0 reading its
//   peers, who wait for it before they leave).
// * Each thread keeps four 16-byte loads in flight (16 KB a CTA of 256
//   threads), and up to 8 CTAs share an SM, enough bytes in flight to cover
//   the memory's latency. Its four accumulator pairs add in a fixed order,
//   then a shuffle tree over the warp and the warps' pairs in order.
// * A row need not start on 16 bytes ((1,3,130,70) bf16 rows are 18,200 bytes
//   long): the elements before the row's first 16-byte boundary (the head)
//   and after its last whole vector (the tail) are read as scalars by CTA 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // 16-byte loads in flight per thread
constexpr long long kCtaElems = 32768;  // elements a CTA of a cluster sums at least
constexpr int kMaxCluster = 8;          // the portable cluster size

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void add(float x, float& s1, float& s2) {
  s1 += x;
  s2 = fmaf(x, x, s2);
}

// one 16-byte vector of T values into (s1, s2)
template <typename T>
__device__ __forceinline__ void add_vec(const uint4& v, float& s1, float& s2) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) add(to_f32(e[i]), s1, s2);
}

// grid: rows * cluster CTAs, clusters of `cluster` consecutive CTAs per row
// (the launch sets the cluster size); out: (2, rows) fp32, sums then sums of squares
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_sums_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows, long long length) {
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // waited on after the loads
  const int nc = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / nc;
  const T* p = x + row * length;
  constexpr int kVec = 16 / sizeof(T);
  const long long head = min(length, (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
  const long long nvec = (length - head) / kVec;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long v0 = nvec * rank / nc, v1 = nvec * (rank + 1) / nc;  // this CTA's vectors

  float a1[kUnroll], a2[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) a1[u] = a2[u] = 0.f;
  long long i = v0 + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < v1; i += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(v + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_vec<T>(r[u], a1[u], a2[u]);
  }
  for (; i < v1; i += kThreads) add_vec<T>(__ldg(v + i), a1[0], a2[0]);
  if (rank == 0) {  // the scalar head and tail
    for (long long j = threadIdx.x; j < head; j += kThreads) add(to_f32(p[j]), a1[1], a2[1]);
    for (long long j = head + nvec * kVec + threadIdx.x; j < length; j += kThreads) add(to_f32(p[j]), a1[2], a2[2]);
  }
  float s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]), s2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  __shared__ float warps[kThreads / 32][2];
  __shared__ float part[kMaxCluster][2];  // in CTA 0: every CTA's pair, by rank
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warps[warp][0] = s1;
    warps[warp][1] = s2;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA of the cluster has started
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      t1 += warps[w][0];
      t2 += warps[w][1];
    }
    float* dst = cluster.map_shared_rank(&part[rank][0], 0);
    dst[0] = t1;
    dst[1] = t2;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // every pair is in CTA 0
  if (rank == 0 && threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < nc; ++r) {
      t1 += part[r][0];
      t2 += part[r][1];
    }
    out[row] = t1;
    out[rows + row] = t2;
  }
}

template <typename T>
int launch(const void* x, void* out, long long rows, long long length, cudaStream_t stream) {
  const long long want = (length + kCtaElems - 1) / kCtaElems;  // CTAs of the row's cluster
  const int nc = static_cast<int>(want > kMaxCluster ? kMaxCluster : want);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * nc));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_sums_kernel<T>, static_cast<const T*>(x),
                                             static_cast<float*>(out), rows, length);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x: rows contiguous rows of `length` elements, dtype 0 bf16, 1 fp16, 2 fp32;
// out: (2, rows) fp32, each row's sum, then each row's sum of squares. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, 1, for another dtype).
extern "C" int vface_gn_sums(const void* x, void* out, int dtype, long long rows, long long length, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || length < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(x, out, rows, length, st);
    case 1: return launch<__half>(x, out, rows, length, st);
    case 2: return launch<float>(x, out, rows, length, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
