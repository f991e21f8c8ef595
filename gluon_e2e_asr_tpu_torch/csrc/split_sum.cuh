// The fixed-order sum of split-K's partial products: K1-bwd's weight
// gradients and db (gemm_f32.cuh's ring_kernel in f32, gemm_sm90.cuh's
// wgrad_kernel in bf16; also K7-bwd's dW_h), and the split f32 dx.
//
// Replaces no TPU kernel. On the TPU the grid runs in order, and
// gluon_e2e_asr_tpu/ops/pallas_lstm.py::_v2_bwd_kernel (:617-643) carries
// each output's sum over the frames in one accumulator, so the order of
// its additions is fixed and a training step is a function of its inputs
// (the JAX package's resume is bit-exact: tests/test_resume_fault.py). On
// Hopper the products split their long depth (the B*T frames) over blocks
// that run in parallel, in no order. Adding the splits' partial tiles into
// the output by float atomics made the order of those additions, and so
// the rounding, differ from run to run. Instead each split stores its
// partial tile whole (zeros where it met no live frame): split 0 into the
// output, split s > 0 into slice s - 1 of a workspace that the wrapper
// takes from PyTorch's allocator. This kernel then adds them in the fixed
// order ((p0 + p1) + p2) + ... + p(S-1): the same bits on every run, on
// any schedule of the blocks.
//
// What bounds it on the H100: bytes, each partial read once and each
// output written once, (S + 1) x 4 bytes an element at 3.35 TB/s (the
// partials were just written and mostly sit in the 50 MB L2). One launch
// covers every output of a call (up to kMaxSegs segments, blockIdx.y),
// 16 bytes a thread where a segment's pointers and widths allow.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace split_sum {

constexpr int kMaxSegs = 6;
constexpr int kThreads = 256;

// out[i] = ((p0[i] + p1[i]) + p2[i]) + ... for i < n, from parts `stride`
// floats apart in `parts`: with out_first, p0 is out's own value (split 0
// stored there) and `parts` holds the nparts after it; else `parts` holds
// all nparts, p0 first.
struct Seg {
  float* out;
  const float* parts;
  long long n, stride;
  int nparts, out_first;
};

struct Args {
  Seg seg[kMaxSegs];
  int nseg;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const __grid_constant__ Args a) {
  const Seg s = a.seg[blockIdx.y];
  const long long step = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int first = s.out_first ? 0 : 1;  // the first part added to p0
  const float* p0 = s.out_first ? s.out : s.parts;
  if (s.n % 4 == 0 && s.stride % 4 == 0 && aligned16(s.out) &&
      aligned16(s.parts)) {
    for (long long i = t0; i < s.n / 4; i += step) {
      float4 v = reinterpret_cast<const float4*>(p0)[i];
      for (int p = first; p < s.nparts; ++p) {
        const float4 w =
            reinterpret_cast<const float4*>(s.parts + p * s.stride)[i];
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      reinterpret_cast<float4*>(s.out)[i] = v;
    }
  } else {
    for (long long i = t0; i < s.n; i += step) {
      float v = p0[i];
      for (int p = first; p < s.nparts; ++p) v += s.parts[p * s.stride + i];
      s.out[i] = v;
    }
  }
}

// Floats of a slice of n, rounded up so that every slice of a workspace
// starts on a 16-byte boundary.
inline long long slice(long long n) { return (n + 3) / 4 * 4; }

// Sums the segments (those with nothing to add skipped) in one launch on
// st; `sms` SMs. Returns cudaGetLastError() after it.
inline cudaError_t launch(const Seg* segs, int nseg, int sms,
                         cudaStream_t st) {
  Args a{};
  long long most = 0;
  for (int i = 0; i < nseg; ++i) {
    const Seg& s = segs[i];
    if (s.n <= 0 || (s.out_first && s.nparts == 0)) continue;
    if (a.nseg == kMaxSegs) return cudaErrorInvalidValue;
    a.seg[a.nseg++] = s;
    most = s.n > most ? s.n : most;
  }
  if (a.nseg == 0) return cudaSuccess;
  const long long blocks = (most / 4 + kThreads - 1) / kThreads;
  const int cap = 4 * sms;
  const dim3 grid(blocks < cap ? (int)(blocks > 0 ? blocks : 1) : cap,
                  a.nseg);
  split_sum_kernel<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace split_sum
