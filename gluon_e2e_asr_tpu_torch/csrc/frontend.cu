// K5 and K6: the fused acoustic frontend, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gluon_e2e_asr_tpu/frontend/pallas_frontend.py:
// compute_features_pallas (K5: pl.pallas_call -> _kernel, one program per
// utterance) and compute_features_pallas_regrid (K6: pl.pallas_call ->
// _regrid_kernel, one program per frame chunk of the whole batch). Same
// math, the ``impl: jnp`` path's (frontend/features.py::compute_features):
//
//   frame f of row b = audio[b, f*hop : f*hop + win]       (valid framing)
//   (re, im)_k = frame . (hann * cos_k, hann * sin_k)      k < n_freq, true f32
//   power_k    = re_k^2 + im_k^2
//   mel_m      = sum_k power_k * melfb[k, m]               true f32
//   x          = log(max(mel_m, log_floor))
//   cmvn none: x; global: (x - mean[m]) / max(std[m], 1e-5); utterance:
//     (x - mu) / sqrt(var + 1e-10), mu and var over the row's valid frames
//     (two passes: the mean, then the squared deviations)
//   SpecAugment (training): cells in a frequency or time mask are 0
//   frames at or past feat_len[b] are 0
//
// SpecAugment is an input. The TPU kernels draw their mask geometry from
// the TPU's own generator inside the kernel, a stream no other device
// reproduces. Here the caller passes the raw draws of
// frontend/features.py::draw_spec_augment (frequency widths and starts,
// time widths and starts, int32 [B, n]) and the kernel applies
// spec_augment's formulas to them: a time mask is capped at
// min(time_width, max(len/5, 1)) and starts at start % max(len - w + 1, 1).
// With the same draws, ``impl: pallas`` and ``impl: jnp`` give the same
// features.
//
// Kernels on the caller's stream, no allocation, no synchronisation, no
// atomics (a run is bit-for-bit repeatable):
//
//   spectral_kernel: one block per (row, tile of kFrames frames), over
//     the whole batch (K6's layout). The block copies the audio its frames
//     span into shared memory (frames overlap, so every sample is read
//     from device memory once; scalar loads, since a frame starts at
//     f*hop samples and a row at b*S, and neither need be 16-byte
//     aligned). The DFT product runs chunk by chunk of kFreqs
//     frequencies against the windowed basis, which the caller lays out
//     with each frequency's cos and sin columns adjacent: a thread keeps
//     the (re, im) pairs of its 8 frames x 4 frequencies in registers, so
//     power = re^2 + im^2 never leaves them. Basis tiles stream from L2
//     (0.8 MB, shared by every block) through shared memory, the next
//     tile's loads in flight during the current tile's product. Each
//     chunk's power goes to shared memory and into the mel product,
//     accumulated in registers across chunks; frequencies past the last
//     whole chunk (n_freq = 257: one) take a warp-per-(frame, frequency)
//     path. Then the log and the epilogue: for cmvn global/none the
//     normalisation, the masks and the valid mask, fused; for utterance
//     CMVN the raw log-mel. A tile whose first frame is past feat_len[b]
//     writes zeros and computes nothing.
//   cmvn_kernel (K5, cmvn utterance): one block per (row, 32 mels), 8
//     frame lanes per mel; the mean, then the variance, each summed by
//     lane and then over the 8 lanes in a fixed order; then normalise,
//     mask and write in one pass.
//
// Entry points: frontend_k5 launches spectral_kernel and, for utterance
// CMVN, cmvn_kernel; frontend_k6 launches spectral_kernel only, and for
// utterance CMVN the caller runs CMVN and SpecAugment in torch, as
// pallas_frontend.py:399-412 runs them in XLA. For cmvn global/none the two
// launch the same spectral kernel.
//
// What bounds it on the card: the operations. A frame costs 2*win*2*n_freq
// + 2*n_freq*M = 4.5e5 f32 operations at 400/257/80, against 1.6 KB of
// audio in and 320 B of features out, so at 67 TFLOP/s the FMA units,
// not the 3.35 TB/s of memory, set the floor. The products stay in true
// f32 on the FMA units: features are log-domain, and the cancellation
// error of a TF32 or bf16 product near the power floor is O(1) after the
// log (the JAX package pins Precision.HIGHEST for the same reason). The
// design keeps 64 independent FMAs per thread between shared-memory
// loads of 8 frame samples (broadcast within a warp) and 4 basis values.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;             // frames per block
constexpr int kFreqs = 128;             // frequencies per DFT chunk
constexpr int kCols = 2 * kFreqs;       // their (cos, sin) columns
constexpr int kKT = 16;                 // window samples per basis tile
constexpr int kPPitch = kFreqs + 4;     // power tile row pitch (floats)
constexpr int kTileLoads = kKT * kCols / 4 / kThreads;  // float4 per thread

enum Norm { kNormNone = 0, kNormGlobal = 1 };

// SpecAugment's raw draws, int32 [B, nf] and [B, nt]; nf = 0 / nt = 0
// where that kind of mask is off.
struct SpecAug {
  const int* fw;
  const int* fs;
  int nf;
  const int* tw;
  const int* ts;
  int nt;
  int time_width;
};

struct Epilogue {
  int norm;           // Norm
  const float* mean;   // [M], kNormGlobal
  const float* stdev;  // [M], kNormGlobal
  SpecAug sa;
};

// Whether cell (f, m) of row b (feat_len len) lies in a SpecAugment mask:
// spec_augment's formulas in frontend/features.py.
__device__ __forceinline__ bool masked(const SpecAug& sa, int b, int f,
                                       int m, int len) {
  for (int i = 0; i < sa.nf; ++i) {
    const int s = sa.fs[b * sa.nf + i];
    if (m >= s && m < s + sa.fw[b * sa.nf + i]) return true;
  }
  if (sa.nt > 0) {
    const int cap = min(max(len / 5, 1), sa.time_width);
    for (int j = 0; j < sa.nt; ++j) {
      const int w = min(sa.tw[b * sa.nt + j], cap);
      const int s = sa.ts[b * sa.nt + j] % max(len - w + 1, 1);
      if (f >= s && f < s + w) return true;
    }
  }
  return false;
}

__device__ __forceinline__ float finish(const Epilogue& e, int b, int f,
                                        int m, float v, int len) {
  if (f >= len) return 0.0f;
  if (e.norm == kNormGlobal) v = (v - e.mean[m]) / fmaxf(e.stdev[m], 1e-5f);
  return masked(e.sa, b, f, m, len) ? 0.0f : v;
}

// features::num_frames: 1 + (n - win) // hop, at least 0.
__device__ __forceinline__ int num_frames(int n, int win, int hop) {
  return n >= win ? 1 + (n - win) / hop : 0;
}

// Grid (ceil(F / kFrames), B), kThreads threads. MP: mels per thread in
// the mel product (16 mel lanes, so M <= 16 * MP). Each row's frame count
// comes from its audio length; the blocks of tile 0 write it to feat_len.
// Dynamic shared memory: the basis tile [kKT][kCols], the power tile
// [kFrames][kPPitch] and the audio span ((kFrames - 1) * hop + win + kKT
// floats; hop % 4 == 0, so each frame's samples start 16-byte aligned).
template <int MP>
__global__ void __launch_bounds__(kThreads, 1)
spectral_kernel(const float* __restrict__ audio, int S,
                const int* __restrict__ audio_len, int* __restrict__ feat_len,
                const float* __restrict__ basis, int ld,
                const float* __restrict__ mel, float* __restrict__ out,
                int F, int win, int hop, int n_freq, int M, float log_floor,
                Epilogue epi) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;
  float* Ps = Bs + kKT * kCols;
  float* As = Ps + kFrames * kPPitch;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int len = num_frames(audio_len[b], win, hop);
  if (blockIdx.x == 0 && tid == 0) feat_len[b] = len;
  if (f0 >= len) {  // every frame of the tile is past the row's end
    for (int i = tid; i < kFrames * M; i += kThreads) {
      const int f = f0 + i / M;
      if (f < F) out[((size_t)b * F + f) * M + i % M] = 0.0f;
    }
    return;
  }

  // The audio the tile's frames span, zero past the row's end.
  const int span = (kFrames - 1) * hop + win + kKT;
  const float* a = audio + (size_t)b * S + (size_t)f0 * hop;
  const int avail = S - f0 * hop;
  for (int i = tid; i < span; i += kThreads) As[i] = i < avail ? a[i] : 0.0f;
  __syncthreads();

  // Mel product: frames mr*4 .. mr*4+3, mels mc + 16*j.
  const int mr = tid / 16, mc = tid % 16;
  float macc[4][MP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MP; ++j) macc[i][j] = 0.0f;

  // DFT product: warp w owns frames 8w .. 8w+7 (its sample loads are
  // broadcasts); lane q owns frequencies 2q, 2q+1 (columns 4q..4q+3 of
  // the tile) and 64+2q, 65+2q (columns 128+4q..).
  const int warp = tid / 32, lane = tid % 32;
  const float* Aw = As + warp * 8 * hop;

  for (int q0 = 0; q0 < n_freq; q0 += kFreqs) {
    const int nq = min(kFreqs, n_freq - q0);
    if (nq == kFreqs) {
      float re[8][4], im[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
      float4 rb[kTileLoads];
      const float* bq = basis + 2 * q0;
      auto fetch = [&](int k0) {
#pragma unroll
        for (int e = 0; e < kTileLoads; ++e) {
          const int v = tid + e * kThreads;
          const int k = k0 + v / (kCols / 4);
          rb[e] = k < win ? __ldg(reinterpret_cast<const float4*>(
                                bq + (size_t)k * ld) + v % (kCols / 4))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < win; k0 += kKT) {
#pragma unroll
        for (int e = 0; e < kTileLoads; ++e)
          reinterpret_cast<float4*>(Bs)[tid + e * kThreads] = rb[e];
        __syncthreads();
        if (k0 + kKT < win) fetch(k0 + kKT);
#pragma unroll
        for (int k4 = 0; k4 < kKT; k4 += 4) {
          // Four samples of each of the warp's frames: one broadcast each.
          float4 x4[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x4[i] = *reinterpret_cast<const float4*>(Aw + i * hop + k0 + k4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // (cos, sin) of frequencies 2q, 2q+1 and 64+2q, 65+2q.
            const float* row = Bs + (k4 + kk) * kCols;
            const float4 lo = reinterpret_cast<const float4*>(row)[lane];
            const float4 hi = reinterpret_cast<const float4*>(row + kCols / 2)[lane];
            const float c[4] = {lo.x, lo.z, hi.x, hi.z};
            const float s[4] = {lo.y, lo.w, hi.y, hi.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float x = kk == 0 ? x4[i].x : kk == 1 ? x4[i].y
                            : kk == 2 ? x4[i].z : x4[i].w;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                re[i][j] = fmaf(x, c[j], re[i][j]);
                im[i][j] = fmaf(x, s[j], im[i][j]);
              }
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* p = Ps + (warp * 8 + i) * kPPitch;
        reinterpret_cast<float2*>(p)[lane] = make_float2(
            re[i][0] * re[i][0] + im[i][0] * im[i][0],
            re[i][1] * re[i][1] + im[i][1] * im[i][1]);
        reinterpret_cast<float2*>(p + kFreqs / 2)[lane] = make_float2(
            re[i][2] * re[i][2] + im[i][2] * im[i][2],
            re[i][3] * re[i][3] + im[i][3] * im[i][3]);
      }
    } else {
      // The last frequencies: one warp per (frame, frequency), the window
      // split over the lanes and summed by a fixed butterfly.
      for (int item = warp; item < kFrames * nq; item += kThreads / 32) {
        const int i = item % kFrames, q = item / kFrames;
        const float* bc = basis + 2 * (q0 + q);
        float re = 0.0f, im = 0.0f;
        for (int n = lane; n < win; n += 32) {
          const float x = As[i * hop + n];
          re = fmaf(x, __ldg(bc + (size_t)n * ld), re);
          im = fmaf(x, __ldg(bc + (size_t)n * ld + 1), im);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          re += __shfl_xor_sync(0xffffffffu, re, o);
          im += __shfl_xor_sync(0xffffffffu, im, o);
        }
        if (lane == 0) Ps[i * kPPitch + q] = re * re + im * im;
      }
    }
    __syncthreads();
    // Mel product over this chunk's frequencies, in order.
    const float* mq = mel + (size_t)q0 * M;
    for (int q = 0; q < nq; ++q) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(mr * 4 + i) * kPPitch + q];
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        const int m = mc + 16 * j;
        const float w = m < M ? __ldg(mq + (size_t)q * M + m) : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) macc[i][j] = fmaf(p[i], w, macc[i][j]);
      }
    }
    __syncthreads();  // the power tile is overwritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + mr * 4 + i;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int m = mc + 16 * j;
      if (m >= M) continue;
      const float v = logf(fmaxf(macc[i][j], log_floor));
      out[((size_t)b * F + f) * M + m] = finish(epi, b, f, m, v, len);
    }
  }
}

// Utterance CMVN, SpecAugment and the valid mask, in place on the raw
// log-mel [B, F, M]. Grid (B, ceil(M / 32)), 256 threads: mel lane
// tid % 32, frame lane tid / 32.
__global__ void __launch_bounds__(256)
cmvn_kernel(float* __restrict__ feats, const int* __restrict__ feat_len,
            int F, int M, SpecAug sa) {
  __shared__ float part[8][32];
  __shared__ float stat[2][32];
  const int b = blockIdx.x;
  const int tx = threadIdx.x % 32, fl = threadIdx.x / 32;
  const int m = blockIdx.y * 32 + tx;
  const bool on = m < M;
  const int len = min(feat_len[b], F);
  const float denom = fmaxf((float)len, 1.0f);
  float* x = feats + (size_t)b * F * M + m;

  float s = 0.0f;
  if (on)
    for (int f = fl; f < len; f += 8) s += x[(size_t)f * M];
  part[fl][tx] = s;
  __syncthreads();
  if (fl == 0) {
    float t = 0.0f;
    for (int l = 0; l < 8; ++l) t += part[l][tx];
    stat[0][tx] = t / denom;
  }
  __syncthreads();
  const float mean = stat[0][tx];
  s = 0.0f;
  if (on)
    for (int f = fl; f < len; f += 8) {
      const float d = x[(size_t)f * M] - mean;
      s += d * d;
    }
  part[fl][tx] = s;
  __syncthreads();
  if (fl == 0) {
    float t = 0.0f;
    for (int l = 0; l < 8; ++l) t += part[l][tx];
    stat[1][tx] = sqrtf(t / denom + 1e-10f);
  }
  __syncthreads();
  const float sd = stat[1][tx];
  if (!on) return;
  for (int f = fl; f < F; f += 8) {
    float v = 0.0f;
    if (f < len && !masked(sa, b, f, m, len)) v = (x[(size_t)f * M] - mean) / sd;
    x[(size_t)f * M] = v;
  }
}

size_t spectral_smem(int win, int hop) {
  return sizeof(float) * ((size_t)kKT * kCols + (size_t)kFrames * kPPitch +
                          (size_t)(kFrames - 1) * hop + win + kKT);
}

template <int MP>
cudaError_t launch_spectral(const float* audio, const int* audio_len,
                            int* feat_len, const float* basis, int ld,
                            const float* mel,
                            float* out, int B, int S, int F, int win, int hop,
                            int n_freq, int M, float log_floor,
                            const Epilogue& epi, cudaStream_t st) {
  const size_t smem = spectral_smem(win, hop);
  cudaError_t e = cudaFuncSetAttribute(
      spectral_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((F + kFrames - 1) / kFrames, B);
  spectral_kernel<MP><<<grid, kThreads, smem, st>>>(
      audio, S, audio_len, feat_len, basis, ld, mel, out, F, win, hop, n_freq, M,
      log_floor, epi);
  return cudaGetLastError();
}

enum Cmvn { kCmvnNone = 0, kCmvnGlobal = 1, kCmvnUtterance = 2 };

// Both entry points: the spectral stage with the epilogue fused for cmvn
// global/none, raw log-mel for utterance CMVN, which cmvn_kernel then
// finishes when `utterance_kernel` is set.
int run(const float* audio, const int* audio_len, int* feat_len,
        const float* basis, int ld,
        const float* mel, const float* mean, const float* stdev, const int* fw,
        const int* fs, int nf, const int* tw, const int* ts, int nt,
        int time_width, float* out, int B, int S, int F, int win, int hop,
        int n_freq, int M, float log_floor, int cmvn, bool utterance_kernel,
        void* stream) {
  if (B <= 0 || F <= 0 || S < (F - 1) * hop + win || win <= 0 || hop <= 0 ||
      hop % 4 != 0 ||
      n_freq <= 0 || M <= 0 || M > 128 || ld < 2 * n_freq || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(basis) % 16 != 0 || cmvn < kCmvnNone ||
      cmvn > kCmvnUtterance || (cmvn == kCmvnGlobal && (!mean || !stdev)) ||
      spectral_smem(win, hop) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SpecAug sa{fw, fs, nf, tw, ts, nt, time_width};
  const SpecAug off{nullptr, nullptr, 0, nullptr, nullptr, 0, 0};
  const bool fused = cmvn != kCmvnUtterance;
  const Epilogue epi{cmvn == kCmvnGlobal ? kNormGlobal : kNormNone, mean,
                     stdev, fused ? sa : off};
  cudaError_t e = M <= 80
      ? launch_spectral<5>(audio, audio_len, feat_len, basis, ld, mel, out, B,
                           S, F, win, hop, n_freq, M, log_floor, epi, st)
      : launch_spectral<8>(audio, audio_len, feat_len, basis, ld, mel, out, B,
                           S, F, win, hop, n_freq, M, log_floor, epi, st);
  if (e != cudaSuccess || fused || !utterance_kernel) return (int)e;
  cmvn_kernel<<<dim3(B, (M + 31) / 32), 256, 0, st>>>(out, feat_len, F, M, sa);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers: audio [B,S] f32;
// audio_len [B] int32; feat_len [B] int32, written (num_frames of each
// row's length); hop a multiple of 4; basis [win, ld]
// f32, 16-byte aligned, frequency k's windowed (cos, sin) at columns 2k,
// 2k+1; mel [n_freq, M] f32; mean, std [M] f32 (cmvn global, else may be
// null); the SpecAugment draws fw, fs [B, nf] and tw, ts [B, nt] int32
// (nf = 0 / nt = 0 where off); out [B, F, M] f32. cmvn: 0 none, 1 global,
// 2 utterance. Returns cudaGetLastError() after the launches (0 on
// success).
//
// K5: for utterance CMVN, the spectral stage and cmvn_kernel.
extern "C" int frontend_k5(const float* audio, const int* audio_len,
                           int* feat_len,
                           const float* basis, int ld, const float* mel,
                           const float* mean, const float* stdev, const int* fw,
                           const int* fs, int nf, const int* tw, const int* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_freq, int M,
                           float log_floor, int cmvn, void* stream) {
  return run(audio, audio_len, feat_len, basis, ld, mel, mean, stdev, fw, fs,
             nf, tw, ts, nt, time_width, out, B, S, F, win, hop, n_freq, M,
             log_floor, cmvn, true, stream);
}

// K6: for utterance CMVN, the raw log-mel (zero past feat_len); the caller
// finishes it.
extern "C" int frontend_k6(const float* audio, const int* audio_len,
                           int* feat_len,
                           const float* basis, int ld, const float* mel,
                           const float* mean, const float* stdev, const int* fw,
                           const int* fs, int nf, const int* tw, const int* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_freq, int M,
                           float log_floor, int cmvn, void* stream) {
  return run(audio, audio_len, feat_len, basis, ld, mel, mean, stdev, fw, fs,
             nf, tw, ts, nt, time_width, out, B, S, F, win, hop, n_freq, M,
             log_floor, cmvn, false, stream);
}

extern "C" const char* frontend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
