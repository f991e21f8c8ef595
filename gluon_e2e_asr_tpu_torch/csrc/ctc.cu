// K2 and K3: the CTC alpha recursion and the fused beta recursion with the
// state posterior, for Hopper (sm_90a).
//
// Replace the TPU kernels gluon_e2e_asr_tpu/ops/pallas_ctc.py::alpha_pallas
// (_alpha_kernel) and ::beta_post_pallas (_beta_post_kernel). Same math on
// the blank-interleaved lattice of S = 2L+1 states, in log space with the
// sentinel NEG_INF = -1e30 (not -inf), and lse3(a, b, c) =
// m' + log(exp(a-m') + exp(b-m') + exp(c-m')) with m' = max(max(a,b,c), NEG_INF):
//
//   alpha, t = 0:  emit on states 0 and 1 (where valid), NEG_INF elsewhere
//   alpha, t > 0:  lse3(a[s], a[s-1], skip[s] ? a[s-2] : NEG_INF) + emit,
//                  NEG_INF on invalid states
//   beta:          emit + lse3(b[s], b[s+1], skipf2[s] ? b[s+2] : NEG_INF);
//                  at a row's last frame it restarts as emit on the two
//                  final states (finalok); NEG_INF on invalid states
//   both freeze a row past its length (the state carries over unchanged);
//   post = exp(clip(alpha + beta - emit - ll, 2*NEG_INF, 0)), 0 on
//          invalid states and past the row's length.
//
// skipf2, finalok and is_last come from the caller, as pallas_ctc.py
// computes them outside its kernel. Exact expf/logf (no fast-math
// intrinsics). Before t = 0 the alpha row holds the lax.scan path's
// initial state (0 at state 0, NEG_INF elsewhere); only a row of length
// 0 ever shows it, and such a row carries no loss.
//
// Design: one block per utterance, one thread per lattice state (S <=
// 1024), the loop over time inside the kernel; the state row is double
// buffered in shared memory, so each step needs one barrier. The reads
// and writes of a [B,S] time slice are coalesced over s. What bounds it:
// the T dependent steps of a few hundred threads each, one barrier and
// one device-memory round trip a step; the tables ([T,B,S] f32, 6 MB at
// T=100, B=96, S=161) stream through once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float ms = fmaxf(m, kNegInf);
  return ms + logf(expf(a0 - ms) + expf(a1 - ms) + expf(a2 - ms));
}

// Grid B, blockDim >= S. emit and alpha [T,B,S] f32; tmask [T,B];
// skip and svalid [B,S]; all masks uint8 (0 or 1).
__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const uint8_t* __restrict__ tmask,
                                 const uint8_t* __restrict__ skip,
                                 const uint8_t* __restrict__ svalid,
                                 float* __restrict__ alpha, int T, int B,
                                 int S) {
  extern __shared__ float as[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const bool sk = on && skip[b * S + s];
  const bool sv = on && svalid[b * S + s];
  const bool first_ok = s <= 1 && sv;
  if (on) as[s] = s == 0 ? 0.0f : kNegInf;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* a = as + cur * S;
    if (on) {
      const size_t at = ((size_t)t * B + b) * S + s;
      const float e = emit[at];
      const float prev = a[s];
      float nw;
      if (t == 0) {
        nw = first_ok ? e : kNegInf;
      } else {
        const float a1 = s >= 1 ? a[s - 1] : kNegInf;
        const float a2 = (sk && s >= 2) ? a[s - 2] : kNegInf;
        nw = sv ? lse3(prev, a1, a2) + e : kNegInf;
      }
      if (!tmask[t * B + b]) nw = prev;  // freeze past the row's length
      as[(cur ^ 1) * S + s] = nw;
      alpha[at] = nw;
    }
    __syncthreads();
    cur ^= 1;
  }
}

// Grid B, blockDim >= S. emit, alpha and post [T,B,S] f32; tmask and
// islast [T,B]; skipf2, svalid and finalok [B,S]; ll [B] f32.
__global__ void ctc_beta_post_kernel(const float* __restrict__ emit,
                                     const uint8_t* __restrict__ tmask,
                                     const uint8_t* __restrict__ islast,
                                     const uint8_t* __restrict__ skipf2,
                                     const uint8_t* __restrict__ svalid,
                                     const uint8_t* __restrict__ finalok,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ ll,
                                     float* __restrict__ post, int T, int B,
                                     int S) {
  extern __shared__ float bs[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const bool sk = on && skipf2[b * S + s];
  const bool sv = on && svalid[b * S + s];
  const bool fok = on && finalok[b * S + s];
  const float llb = ll[b];
  if (on) bs[s] = kNegInf;
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    const float* bc = bs + cur * S;
    if (on) {
      const size_t at = ((size_t)t * B + b) * S + s;
      const float e = emit[at];
      const bool tm = tmask[t * B + b];
      const float prev = bc[s];
      const float b1 = s + 1 < S ? bc[s + 1] : kNegInf;
      const float b2 = (sk && s + 2 < S) ? bc[s + 2] : kNegInf;
      float nw = e + lse3(prev, b1, b2);
      if (islast[t * B + b]) nw = fok ? e : kNegInf;
      if (!sv) nw = kNegInf;
      if (!tm) nw = prev;
      bs[(cur ^ 1) * S + s] = nw;
      const float gamma = alpha[at] + nw - e;
      const float p = expf(fminf(fmaxf(gamma - llb, 2.0f * kNegInf), 0.0f));
      post[at] = (sv && tm) ? p : 0.0f;
    }
    __syncthreads();
    cur ^= 1;
  }
}

int threads_for(int S) { return ((S + 31) / 32) * 32; }

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers, layouts as in
// the kernels above; S <= 1024. Each returns cudaGetLastError() after its
// launch (0 on success).
extern "C" int ctc_alpha(const float* emit, const uint8_t* tmask,
                         const uint8_t* skip, const uint8_t* svalid,
                         float* alpha, int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0 || S > 1024) return (int)cudaErrorInvalidValue;
  ctc_alpha_kernel<<<B, threads_for(S), 2 * S * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      emit, tmask, skip, svalid, alpha, T, B, S);
  return (int)cudaGetLastError();
}

extern "C" int ctc_beta_post(const float* emit, const uint8_t* tmask,
                             const uint8_t* islast, const uint8_t* skipf2,
                             const uint8_t* svalid, const uint8_t* finalok,
                             const float* alpha, const float* ll, float* post,
                             int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0 || S > 1024) return (int)cudaErrorInvalidValue;
  ctc_beta_post_kernel<<<B, threads_for(S), 2 * S * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      emit, tmask, islast, skipf2, svalid, finalok, alpha, ll, post, T, B, S);
  return (int)cudaGetLastError();
}

extern "C" const char* ctc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
