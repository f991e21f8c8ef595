// Small device helpers shared by the BiLSTM kernels (bilstm_fwd.cu,
// bilstm_bwd.cu), and what their two cluster recurrences
// (fwd_cluster_kernel, bwd_cluster_kernel) share: the partition of the
// hidden units over a cluster of 16 CTAs, the rule that picks the rows a
// cluster, and the split cluster barrier.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace port {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four adjacent weights as one 16-byte (f32) or 8-byte (bf16) load. The
// recurrence kernels lay W_h out so that the four values a thread needs
// for one product row are adjacent (see each kernel's header).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Four adjacent weights from shared memory.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---------------------------------------------------------------------------
// The cluster recurrences
// ---------------------------------------------------------------------------

constexpr int kCtas = 16;               // CTAs per cluster
constexpr int kClusterMaxHidden = 320;  // larger H takes the L2 kernels
constexpr int kMaxRows = 48;            // rows per cluster, at most
constexpr int kRowStep = 16;            // rows per cluster, in steps of
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block

// Returned, without launching, when no cluster of the kernel fits.
constexpr int kNoClusterFits = -1;

// Hidden units owned by one CTA: a multiple of 4 (one 16-byte store of 4
// units never straddles two owners); 16 of them cover H.
__host__ __device__ __forceinline__ int cluster_units(int H) {
  return 4 * ((H + 63) / 64);
}

// Rows a cluster for B batch rows: the fewest of 16, 32 and 48 whose
// 2 * ceil(B / R) clusters (two directions) the device holds at once, else
// 48, and the clusters run in waves. A step's work is about proportional
// to R, so fewer rows and more clusters are faster while they fit in one
// wave. capacity(R, &n) sets n to the clusters of R rows the device holds
// at once; *clusters is left at that count for the R chosen.
template <typename Capacity>
cudaError_t cluster_rows(int B, Capacity capacity, int* R, int* clusters) {
  *R = kMaxRows;
  for (int r = kRowStep; r <= kMaxRows; r += kRowStep) {
    cudaError_t e = capacity(r, clusters);
    if (e != cudaSuccess) return e;
    if (2 * ((B + r - 1) / r) <= *clusters) {
      *R = r;
      return cudaSuccess;
    }
  }
  return capacity(kMaxRows, clusters);
}

// The launch configuration of a cluster recurrence `kernel` for `groups`
// groups of rows in each of the two directions: kCtas * groups * 2 blocks
// of `threads` threads (rounded up to warps), clusters of kCtas (a
// non-portable size), `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t smem, int threads,
                           int groups, cudaStream_t st,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCtas * groups * 2);
  cfg->blockDim = dim3(32 * ((threads + 31) / 32));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of `kernel`, configured as cluster_config does, the
// device holds at once (cudaOccupancyMaxActiveClusters), asked once and
// kept in `known` (0 until asked).
template <typename Kernel>
cudaError_t cluster_capacity(Kernel kernel, size_t smem, int threads,
                             cudaStream_t st, int& known, int* clusters) {
  if (known == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = cluster_config(kernel, smem, threads, 1, st, &cfg, &attr);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    known = n + 1;
  }
  *clusters = known - 1;
  return cudaSuccess;
}

// The two halves of a cluster barrier: stores before the arrival are
// visible to every CTA of the cluster after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace port
