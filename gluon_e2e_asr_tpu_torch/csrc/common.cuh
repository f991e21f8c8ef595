// Small device helpers shared by the BiLSTM kernels (bilstm_fwd.cu,
// bilstm_bwd.cu).
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

}  // namespace port
