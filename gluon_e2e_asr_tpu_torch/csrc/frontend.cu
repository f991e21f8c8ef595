// K5 and K6: the fused acoustic frontend, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gluon_e2e_asr_tpu/frontend/pallas_frontend.py:
// compute_features_pallas (K5: pl.pallas_call -> _kernel, one program per
// utterance) and compute_features_pallas_regrid (K6: pl.pallas_call ->
// _regrid_kernel, one program per frame chunk of the whole batch). The two
// differ on the TPU only in their tiling; here one kernel serves both
// entries. Same math, the ``impl: jnp`` path's
// (frontend/features.py::compute_features):
//
//   frame f of row b = audio[b, f*hop : f*hop + win]       (valid framing)
//   X_k        = sum_n frame_n hann_n e^{-2 pi i n k / n_fft}, k <= n_fft/2
//   power_k    = |X_k|^2                                   true f32
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
// atomics (a run is bit-for-bit repeatable). The route is chosen by shape
// alone (fe_fft_plan, mirrored by frontend/fused.py::fft_plan):
//
//   fft_kernel (n_fft a power of two in [kMinFft, kMaxFft], win <= n_fft,
//     n_mels <= kMaxMels, the plan's shared memory within a block's): one
//     thread-block cluster of kCluster CTAs an utterance; rank r owns a
//     contiguous range of the row's valid frames (split) and writes a
//     range of the frames past them as zeros.
//     - Audio: the CTA stages the samples of up to kChunk of its frames
//       ((Q - 1) * hop + n_fft floats, zero past the row's end) into
//       shared memory with 4-byte cp.async copies (a row starts at b*S
//       floats, so it need not be 16-byte aligned): every sample is read
//       from device memory once a chunk.
//     - FFT, one warp a frame: the windowed frame's even and odd samples
//       packed as n_fft/2 complex points, a Stockham complex FFT of
//       radix E = n_fft/64 (then one smaller pass) with each lane's
//       butterflies in registers and the passes exchanged through the
//       warp's own slice of shared memory (__syncwarp, no block barrier);
//       twiddles built on the host in f64, stored in f32, kept in shared
//       memory; then the real split to the n_fft/2 + 1 bins and
//       power = re^2 + im^2 in registers, the same path for every bin.
//     - Mel over its band: each mel's run of bins from the host (first
//       bin and weight offset multiples of 4, whole groups of 4 bins, zero
//       weights outside the band: they add exactly nothing), a group one
//       16-byte load of power and one of weights and four FMAs, in bin
//       order; log.
//     - The CTA's raw log-mel stays in shared memory. For utterance CMVN
//       each CTA sums each mel over its frames (thread groups of frames,
//       added in a fixed order) and stores the sums into a slot of every
//       CTA of the cluster (distributed shared memory); after a cluster
//       barrier each CTA adds its kCluster slots in rank order
//       (bit-identical stats in every CTA): the mean; then the squared
//       deviations the same way. cmvn global and none skip this.
//     - Epilogue: normalise, SpecAugment (masked), the valid mask, and
//       [frame, mel] rows written with coalesced stores.
//   spectral_kernel (every other shape, e.g. n_fft = 400; and every shape
//     in the first design's build, FE_FFT 0): one block per (row, tile of
//     kFrames frames), over the whole batch (K6's layout). The block
//     copies the audio its frames span into shared memory (frames
//     overlap, so every sample is read from device memory once; scalar
//     loads). The DFT product runs chunk by chunk of kFreqs frequencies
//     against the windowed basis, which the caller lays out with each
//     frequency's cos and sin columns adjacent: a thread keeps the (re,
//     im) pairs of its 8 frames x 4 frequencies in registers. Basis tiles
//     stream from L2 through shared memory. Each chunk's power goes into
//     the mel product, accumulated in registers across chunks;
//     frequencies past the last whole chunk take a warp-per-(frame,
//     frequency) path. Then the log and, for cmvn global/none, the
//     epilogue; for utterance CMVN the raw log-mel, which
//   cmvn_kernel finishes: one block per (row, 32 mels), 8 frame lanes per
//     mel; the mean, then the variance, each summed by lane and then over
//     the 8 lanes in a fixed order; then normalise, mask and write.
//
// What bounds it on the card. The FFT route costs about
// 5 (n_fft/2) log2(n_fft/2) operations a frame for the complex FFT, 13
// a bin for the real split and the power, two a nonzero mel weight and
// one a window sample: 1.5e4 at 512/400/80, against 1.6 KB of audio in
// and 320 B of features out, so the bytes (3.35 TB/s) and the launch,
// not the FMA units, set its floor. The DFT product (spectral_kernel)
// costs 2*win*2*n_freq + 2*n_freq*M = 4.5e5 operations a frame, so there
// the FMA units set the floor. Both stay in true f32 on the FMA units:
// features are log-domain, and the cancellation error of a TF32 or bf16
// product near the power floor is O(1) after the log (the JAX package
// pins Precision.HIGHEST for the same reason).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// 1: the FFT route where its plan fits; 0: the first design
// (spectral_kernel for every shape, K6 leaving utterance CMVN to its
// caller), kept for tools/fe_probe.py's A/B in one process.
#define FE_FFT 1
// Cuts for tools/fe_probe.py --ablate (each computes wrong features; only
// its time counts): FE_MEL 0 skips the mel product and the log (FFT
// only), FE_REDUCE 0 the utterance CMVN reduction, FE_STORES 0 the
// features' stores.
#define FE_MEL 1
#define FE_REDUCE 1
#define FE_STORES 1
// 1: thread 0 of every CTA of fft_kernel adds the SM cycles of each of
// its phases (FftPhase) to fe_phase_cycles, which frontend_phase_cycles
// reads and clears (tools/fe_probe.py --phases); 0: no counting.
#define FE_TIMING 0

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kFrames = 64;             // frames per block
constexpr int kFreqs = 128;             // frequencies per DFT chunk
constexpr int kCols = 2 * kFreqs;       // their (cos, sin) columns
constexpr int kKT = 16;                 // window samples per basis tile
constexpr int kPPitch = kFreqs + 4;     // power tile row pitch (floats)
constexpr int kTileLoads = kKT * kCols / 4 / kThreads;  // float4 per thread
constexpr int kMaxMels = 128;           // 16 mel lanes x 8 mels a thread
constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory

enum Norm { kNormNone = 0, kNormGlobal = 1 };
enum Cmvn { kCmvnNone = 0, kCmvnGlobal = 1, kCmvnUtterance = 2 };

// SpecAugment's raw draws, int64 [B, nf] and [B, nt] (draw_spec_augment's
// tensors as they are); nf = 0 / nt = 0 where that kind of mask is off.
struct SpecAug {
  const long long* fw;
  const long long* fs;
  int nf;
  const long long* tw;
  const long long* ts;
  int nt;
  int time_width;
};

struct Epilogue {
  int norm;           // Norm
  const float* mean;   // [M], kNormGlobal
  const float* stdev;  // [M], kNormGlobal
  SpecAug sa;
};

// Whether mel m of row b lies in a SpecAugment frequency mask, and
// whether frame f of row b (feat_len len) lies in a time mask:
// spec_augment's formulas in frontend/features.py.
__device__ __forceinline__ bool freq_masked(const SpecAug& sa, int b, int m) {
  for (int i = 0; i < sa.nf; ++i) {
    const long long s = sa.fs[b * sa.nf + i];
    if (m >= s && m < s + sa.fw[b * sa.nf + i]) return true;
  }
  return false;
}

__device__ __forceinline__ bool time_masked(const SpecAug& sa, int b, int f,
                                            int len) {
  if (sa.nt > 0) {
    const int cap = min(max(len / 5, 1), sa.time_width);
    for (int j = 0; j < sa.nt; ++j) {
      const int w = (int)min(sa.tw[b * sa.nt + j], (long long)cap);
      const int s = (int)(sa.ts[b * sa.nt + j] % max(len - w + 1, 1));
      if (f >= s && f < s + w) return true;
    }
  }
  return false;
}

__device__ __forceinline__ bool masked(const SpecAug& sa, int b, int f,
                                       int m, int len) {
  return freq_masked(sa, b, m) || time_masked(sa, b, f, len);
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

// The spectral stage with the epilogue fused for cmvn global/none, raw
// log-mel for utterance CMVN, which cmvn_kernel then finishes when
// `utterance_kernel` is set.
int run_spectral(const float* audio, const int* audio_len, int* feat_len,
                 const float* basis, int ld, const float* mel, const SpecAug& sa,
                 const float* mean, const float* stdev, float* out, int B,
                 int S, int F, int win, int hop, int n_freq, int M,
                 float log_floor, int cmvn, bool utterance_kernel,
                 cudaStream_t st) {
  if (ld < 2 * n_freq || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(basis) % 16 != 0 || !mel ||
      spectral_smem(win, hop) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
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

// The arguments every entry validates the same way.
bool valid_shape(int B, int S, int F, int win, int hop, int M, int cmvn,
                 const float* mean, const float* stdev) {
  return B > 0 && F > 0 && S >= (F - 1) * hop + win && win > 0 && hop > 0 &&
         hop % 4 == 0 && M > 0 && M <= kMaxMels && cmvn >= kCmvnNone &&
         cmvn <= kCmvnUtterance &&
         (cmvn != kCmvnGlobal || (mean && stdev));
}

#if FE_FFT

// ---------------------------------------------------------------------------
// The FFT route
// ---------------------------------------------------------------------------

constexpr int kCluster = 8;         // CTAs an utterance (portable)
constexpr int kFftWarps = 16;       // one frame a warp at a time
constexpr int kFftThreads = 32 * kFftWarps;
constexpr int kChunk = 64;          // frames whose audio a CTA stages at once
constexpr int kMinFft = 128;        // two complex points a lane
constexpr int kMaxFft = 2048;       // 32 complex points a lane
constexpr int kRouteSpectral = 0;
constexpr int kRouteFft = 1;
constexpr int kRouteMismatch = -2;  // the caller's route is not the plan's

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// A warp's slice: n_fft/2 complex points, one float2 of padding every 8
// (pad()), so that a pass's strided stores spread over the banks.
__host__ __device__ constexpr size_t slice_floats(int n_fft) {
  return 9 * (size_t)n_fft / 8;
}

// The FFT kernel's dynamic shared memory, offsets in floats (each a
// multiple of 4): the twiddles (n_fft complex), the window (n_fft, zero
// past win), a slice a warp, the CMVN sums (the cluster's CTAs' sums
// that the CTA receives, [2 passes][kCluster][kMaxMels], and its threads',
// [kFftThreads]), the CTA's raw log-mel (P frames x M) and the audio of a
// chunk of Q frames ((Q - 1) * hop + n_fft samples).
struct FftSmem {
  size_t tw, win, slices, stats, logmel, audio, total;
  __host__ __device__ FftSmem(int n_fft, int hop, int M, int P, int Q) {
    tw = 0;
    win = tw + 2 * (size_t)n_fft;
    slices = win + n_fft;
    stats = slices + kFftWarps * slice_floats(n_fft);
    logmel = stats + 2 * kCluster * kMaxMels + kFftThreads;
    audio = logmel + round4((size_t)P * M);
    total = audio + round4((size_t)(Q - 1) * hop + n_fft);
  }
};

// How a launch covers [B, F] frames: the route, P frames a CTA at most
// (ceil(F / kCluster)), Q frames a staged chunk, and the FFT kernel's
// shared memory in bytes.
struct FftPlan {
  int route, P, Q;
  size_t smem;
};

FftPlan fe_fft_plan(int F, int win, int hop, int n_fft, int M) {
  FftPlan p;
  p.P = (F + kCluster - 1) / kCluster;
  p.Q = p.P < kChunk ? p.P : kChunk;
  p.smem = sizeof(float) * FftSmem(n_fft, hop, M, p.P, p.Q).total;
  const bool shape = n_fft >= kMinFft && n_fft <= kMaxFft &&
                     (n_fft & (n_fft - 1)) == 0 && win <= n_fft &&
                     M <= kMaxMels;
  p.route = shape && p.smem <= kMaxSmem ? kRouteFft : kRouteSpectral;
  return p;
}

// Rank r's frames of a row with `live` valid frames of F: [lo, hi) of
// the valid frames, ceil(live / kCluster) a rank, which it computes, and
// [zlo, zhi) of the frames past them, ceil((F - live) / kCluster) a rank,
// which it writes as zeros.
__host__ __device__ inline void split(int live, int F, int r, int* lo,
                                      int* hi, int* zlo, int* zhi) {
  const int n = (live + kCluster - 1) / kCluster;
  const int z = (F - live + kCluster - 1) / kCluster;
  *lo = r * n < live ? r * n : live;
  *hi = *lo + n < live ? *lo + n : live;
  *zlo = live + (r * z < F - live ? r * z : F - live);
  *zhi = *zlo + z < F ? *zlo + z : F;
}

__host__ __device__ constexpr int bitrev(int i, int n) {
  int r = 0;
  for (int b = 1; b < n; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// A slice index with one float2 of padding every 8. For i = a + c with c
// a multiple of 8, pad(i) = pad(a) + pad(c): the kernel computes one
// padded base a lane and addresses the rest by constant offsets.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// v[base .. base+R) in natural order in and out: their R-point DFT,
// radix-2 decimation in time (bit-reversed order, then log2 R stages);
// W_R^q = tw[q * step].
template <int R, int E>
__device__ __forceinline__ void dft(float2 (&v)[E], int base,
                                    const float2* tw, int step) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = bitrev(i, R);
    if (i < j) {
      const float2 t = v[base + i];
      v[base + i] = v[base + j];
      v[base + j] = t;
    }
  }
#pragma unroll
  for (int h = 1; h < R; h *= 2) {
#pragma unroll
    for (int q = 0; q < h; ++q) {
      const float2 w = tw[q * (R / (2 * h)) * step];
#pragma unroll
      for (int s = 0; s < R; s += 2 * h) {
        const float2 x = v[base + s + q];
        const float2 y = q == 0 ? v[base + s + q + h]
                                : cmul(v[base + s + q + h], w);
        v[base + s + q] = make_float2(x.x + y.x, x.y + y.y);
        v[base + s + q + h] = make_float2(x.x - y.x, x.y - y.y);
      }
    }
  }
}

// One Stockham pass of radix R over the warp's slice, stride Ns (the
// size of the sub-transforms already done): butterfly j (E/R a lane,
// j = lane + 32b) reads points j + r * 32E/R, multiplies point r by
// W_{Ns R}^{(j mod Ns) r}, takes their R-point DFT and writes output r
// at (j - j mod Ns) R + j mod Ns + r Ns. All reads of the warp land
// before any write.
template <int R, int E, int Ns>
__device__ __forceinline__ void pass(float2* s, int lane, const float2* tw) {
  constexpr int N2 = 32 * E, NB = E / R, C = N2 / R, n_fft = 2 * N2;
  const float2* src = s + pad(lane);  // 32b + rC is a multiple of 8
  float2 v[E];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = lane + 32 * b, kd = (j & (Ns - 1)) * (n_fft / (Ns * R));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[b * R + r] = src[pad(32 * b + r * C)];
      if (r > 0) v[b * R + r] = cmul(v[b * R + r], tw[r * kd]);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) dft<R>(v, b * R, tw, n_fft / R);
  __syncwarp();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = lane + 32 * b, k = j & (Ns - 1);
    const int d = (j - k) * R + k;
    if constexpr (Ns % 8 == 0) {
      float2* dst = s + pad(d);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[pad(r * Ns)] = v[b * R + r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) s[pad(d + r * Ns)] = v[b * R + r];
    }
  }
  __syncwarp();
}

// The passes after the first: radix E while a whole pass fits, then one
// of the radix left (n_fft/2 = 32E over the largest power of E that
// divides it).
template <int E, int Ns>
__device__ __forceinline__ void passes(float2* s, int lane, const float2* tw) {
  constexpr int N2 = 32 * E;
  if constexpr (Ns * E <= N2) {
    pass<E, E, Ns>(s, lane, tw);
    passes<E, Ns * E>(s, lane, tw);
  } else if constexpr (Ns < N2) {
    pass<N2 / Ns, E, Ns>(s, lane, tw);
  }
}

// The power spectrum of one frame (samples x[0 .. n_fft), window win,
// zero past its length) into the warp's slice as floats p[0 .. n_fft/2],
// then zeros to p[n_fft/2 + 3] (a mel's last group of 4 bins may reach
// there).
template <int E>
__device__ __forceinline__ void frame_power(const float* x, const float* win,
                                            const float2* tw, float2* s,
                                            int lane) {
  constexpr int N2 = 32 * E, n_fft = 2 * N2;
  // The first pass (Ns = 1, radix E, no twiddles) from the windowed
  // frame: lane j takes the complex points j + 32r, z_m = (x_2m, x_2m+1),
  // and writes its outputs at jE + r.
  const float2* xl = reinterpret_cast<const float2*>(x) + lane;
  const float2* wl = reinterpret_cast<const float2*>(win) + lane;
  float2 v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const float2 a = xl[32 * r], w = wl[32 * r];
    v[r] = make_float2(a.x * w.x, a.y * w.y);
  }
  dft<E>(v, 0, tw, n_fft / E);
  __syncwarp();  // the slice's last reads (the previous frame's mel) are done
  float2* dst = s + pad(lane * E);  // (lane E) mod 8 + r < 8 where E < 8
#pragma unroll
  for (int r = 0; r < E; ++r) dst[r + (r >> 3)] = v[r];
  __syncwarp();
  passes<E, E>(s, lane, tw);
  // The real split: X_k = (Z_k + conj Z_{N2-k}) / 2
  //                       - i W^k (Z_k - conj Z_{N2-k}) / 2, k = 0 .. N2:
  // k = lane + 32q, Z_k at pad(lane) + pad(32q), Z_{N2-k} at
  // pad(32 - lane) + pad(32(E - 1 - q)) (Z_0 for k = 0 and k = N2).
  const float2* zl = s + pad(lane);
  const float2* cl = s + pad(32 - lane);
  const float2* tl = tw + lane;
  float pw[E + 1];
#pragma unroll
  for (int q = 0; q <= E; ++q) {
    pw[q] = 0.0f;
    if (q < E || lane == 0) {
      const float2 z = q < E ? zl[pad(32 * q)] : s[0];
      const float2 c = q == E ? s[0]
                     : q == 0 ? (lane ? cl[pad(32 * (E - 1))] : s[0])
                              : cl[pad(32 * (E - 1 - q))];
      const float2 t = cmul(make_float2(z.x - c.x, z.y + c.y), tl[32 * q]);
      const float re = 0.5f * (z.x + c.x + t.y);
      const float im = 0.5f * (z.y - c.y - t.x);
      pw[q] = re * re + im * im;
    }
  }
  __syncwarp();
  float* pl = reinterpret_cast<float*>(s) + lane;
#pragma unroll
  for (int q = 0; q <= E; ++q)  // and zeros past bin N2 to N2 + 3
    if (q < E || lane < 4) pl[32 * q] = pw[q];
  __syncwarp();
}

// 4-byte cp.async copies of src[0 .. n) into dst, zero from `avail` on
// (read from src, 0 bytes), by the block's threads.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int avail) {
  for (int i = threadIdx.x; i < n; i += kFftThreads) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(i < avail ? src + i : src), "r"(i < avail ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// fft_kernel's phases as FE_TIMING counts them on thread 0 (warp 0):
// staging a chunk, its frames' FFTs and their mel products and logs, the
// wait for the other warps' frames, the CMVN mean (the CTA's sums, the
// stores into the peers, a cluster barrier), the deviations (the mean,
// the sums, the stores, a barrier), the std, the stores of the features,
// the end.
enum FftPhase { kStage, kFft, kMel, kFramesWait, kMean, kVar, kStd, kStores,
                kExit, kPhases };

#if FE_TIMING
__device__ unsigned long long fe_phase_cycles[kPhases + 1];  // + CTAs
#define FE_PHASE(p)                          \
  do {                                       \
    if (threadIdx.x == 0) {                  \
      const long long now_ = clock64();      \
      fe_acc[p] += now_ - fe_t0;             \
      fe_t0 = now_;                          \
    }                                        \
  } while (0)
#else
#define FE_PHASE(p)
#endif

// The sum of the G threads' sums of mel m, in order.
__device__ __forceinline__ float group_sum(const float* grp, int G, int M,
                                           int m) {
  float t = 0.0f;
  for (int j = 0; j < G; ++j) t += grp[j * M + m];
  return t;
}

// This CTA's sum v of mel m into slot [rank][m] of every CTA of the
// cluster (stores into their shared memory; a cluster barrier makes them
// visible).
__device__ __forceinline__ void share(cg::cluster_group& cluster, float* slots,
                                      int rank, int m, float v) {
#pragma unroll
  for (int q = 0; q < kCluster; ++q)
    *cluster.map_shared_rank(slots + rank * kMaxMels + m, q) = v;
}

// The kCluster slots of mel m, added in rank order.
__device__ __forceinline__ float rank_sum(const float* slots, int m) {
  float t = 0.0f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) t += slots[q * kMaxMels + m];
  return t;
}

struct FftArgs {
  const float* audio;      // [B, S]
  const int* audio_len;    // [B]
  int* feat_len;           // [B], written
  const float* consts;     // twiddles [n_fft][2] (cos, -sin), window [n_fft]
  const int* bands;        // [M][3]: first bin, bins, weight offset
  const float4* weights;   // each mel's run of weights, in bin order
  float* out;              // [B, F, M]
  int S, F, win, hop, n_fft, M, P, Q, cmvn;
  float log_floor;
  Epilogue epi;            // norm: global or none; the SpecAugment draws
};

// Grid kCluster * B, clusters of kCluster, kFftThreads threads; E =
// n_fft / 64 complex points a lane. Dynamic shared memory: FftSmem.
template <int E>
__global__ void __launch_bounds__(kFftThreads)
fft_kernel(const FftArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int n_fft = 64 * E;
  const FftSmem lay(n_fft, a.hop, a.M, a.P, a.Q);
  const float2* tw = reinterpret_cast<const float2*>(smem + lay.tw);
  const float* win = smem + lay.win;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float2* s = reinterpret_cast<float2*>(smem + lay.slices +
                                        warp * slice_floats(n_fft));
  float* recv = smem + lay.stats;  // [2][kCluster][kMaxMels]: CTAs' sums
  float* grp = recv + 2 * kCluster * kMaxMels;  // [kFftThreads]: threads'
  const bool utt = a.cmvn == kCmvnUtterance && FE_REDUCE;
  if (utt) port::cluster_arrive();  // this CTA runs: its peers may store
  float* L = smem + lay.logmel;
  float* A = smem + lay.audio;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int len = num_frames(a.audio_len[b], a.win, a.hop);
  const int live = min(len, a.F);
  if (rank == 0 && tid == 0) a.feat_len[b] = len;
  int lo, hi, zlo, zhi;
  split(live, a.F, rank, &lo, &hi, &zlo, &zhi);
#if FE_TIMING
  long long fe_acc[kPhases] = {};
  long long fe_t0 = clock64();
#endif

  // This lane's mels: lane + 32i; their runs in groups of 4 bins.
  int first[kMaxMels / 32], count[kMaxMels / 32], off[kMaxMels / 32];
#pragma unroll
  for (int i = 0; i < kMaxMels / 32; ++i) {
    const int m = lane + 32 * i;
    first[i] = m < a.M ? __ldg(a.bands + 3 * m) / 4 : 0;
    count[i] = m < a.M ? __ldg(a.bands + 3 * m + 1) / 4 : 0;
    off[i] = m < a.M ? __ldg(a.bands + 3 * m + 2) / 4 : 0;
  }

  const float* row = a.audio + (size_t)b * a.S;
  for (int c0 = lo; c0 < hi; c0 += a.Q) {
    const int n = min(a.Q, hi - c0);
    if (c0 == lo) stage(smem, a.consts, 3 * n_fft, 3 * n_fft);
    stage(A, row + (size_t)c0 * a.hop, (n - 1) * a.hop + n_fft,
          a.S - c0 * a.hop);
    staged();
    __syncthreads();
    FE_PHASE(kStage);
    for (int f = c0 + warp; f < c0 + n; f += kFftWarps) {
      frame_power<E>(A + (f - c0) * a.hop, win, tw, s, lane);
      FE_PHASE(kFft);
      const float4* p = reinterpret_cast<const float4*>(s);
      float* Lf = L + (size_t)(f - lo) * a.M;
#pragma unroll
      for (int i = 0; i < kMaxMels / 32; ++i) {
        const int m = lane + 32 * i;
        if (m < a.M) {
#if FE_MEL
          float acc = 0.0f;
          for (int t = 0; t < count[i]; ++t) {
            const float4 x = p[first[i] + t];
            const float4 w = __ldg(a.weights + off[i] + t);
            acc = fmaf(x.x, w.x, acc);
            acc = fmaf(x.y, w.y, acc);
            acc = fmaf(x.z, w.z, acc);
            acc = fmaf(x.w, w.w, acc);
          }
          Lf[m] = logf(fmaxf(acc, a.log_floor));
#else
          Lf[m] = reinterpret_cast<const float*>(p)[m];
#endif
        }
      }
      FE_PHASE(kMel);
    }
    __syncthreads();  // the chunk's audio is overwritten by the next one
    FE_PHASE(kFramesWait);
  }

  // Utterance CMVN: the cluster's sums in rank order, twice. Thread
  // (g, m) = (tid / M, tid % M), g < G = kFftThreads / M, takes mel m of
  // the CTA's frames g, g + G, ... in order; thread m adds the G sums in
  // order (the CTA's sum) and stores it into slot [rank][m] of every CTA
  // of the cluster; after a cluster barrier every thread of mel m adds
  // its CTA's kCluster slots in rank order.
  const int nf = hi - lo, G = kFftThreads / a.M;
  const int g = tid / a.M, m = tid % a.M;
  const bool on = g < G;
  float mean = 0.0f, sd = 1.0f;
  if (utt) {
    const float denom = fmaxf((float)live, 1.0f);
    float t = 0.0f;
    if (on)
      for (int i = g; i < nf; i += G) t += L[i * a.M + m];
    grp[tid] = t;
    __syncthreads();
    port::cluster_wait();  // every CTA of the cluster runs
    if (tid < a.M) share(cluster, recv, rank, tid, group_sum(grp, G, a.M, tid));
    port::cluster_arrive();
    port::cluster_wait();
    FE_PHASE(kMean);
    if (on) mean = rank_sum(recv, m) / denom;
    t = 0.0f;
    if (on)
      for (int i = g; i < nf; i += G) {
        const float d = L[i * a.M + m] - mean;
        t += d * d;
      }
    grp[tid] = t;
    __syncthreads();
    float* recv2 = recv + kCluster * kMaxMels;
    if (tid < a.M)
      share(cluster, recv2, rank, tid, group_sum(grp, G, a.M, tid));
    port::cluster_arrive();
    port::cluster_wait();  // no peer accesses this CTA after this
    FE_PHASE(kVar);
    if (on) sd = sqrtf(rank_sum(recv2, m) / denom + 1e-10f);
    FE_PHASE(kStd);
  }

#if FE_STORES
  // Thread (g, m) writes mel m of frames g, g + G, ... (a warp's stores
  // are consecutive mels): normalised ((x - 0) / 1 == x for cmvn none),
  // SpecAugment, and the frames past the row's end as zeros.
  if (on) {
    if (a.epi.norm == kNormGlobal) {
      mean = a.epi.mean[m];
      sd = fmaxf(a.epi.stdev[m], 1e-5f);
    }
    const bool fmask = freq_masked(a.epi.sa, b, m);
    float* out = a.out + ((size_t)b * a.F + lo) * a.M + m;
    for (int i = g; i < nf; i += G) {
      const float v = (L[i * a.M + m] - mean) / sd;
      out[(size_t)i * a.M] =
          fmask || time_masked(a.epi.sa, b, lo + i, len) ? 0.0f : v;
    }
  }
  float* zero = a.out + ((size_t)b * a.F + zlo) * a.M;
  for (int i = tid; i < (zhi - zlo) * a.M; i += kFftThreads) zero[i] = 0.0f;
#endif
  FE_PHASE(kStores);
#if FE_TIMING
  FE_PHASE(kExit);
  if (tid == 0) {
    for (int p = 0; p < kPhases; ++p)
      atomicAdd(fe_phase_cycles + p, (unsigned long long)fe_acc[p]);
    atomicAdd(fe_phase_cycles + kPhases, 1ull);
  }
#endif
}

// Launches fft_kernel<E> over B clusters; kNoClusterFits without
// launching when the device holds none (cudaOccupancyMaxActiveClusters,
// asked once per shared-memory size). The attribute is set on every call.
template <int E>
int launch_fft(const FftArgs& a, int B, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      fft_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kFftThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static size_t known_smem = 0;
  static int known = 0;
  if (known_smem != smem) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (void*)fft_kernel<E>, &cfg);
    if (e != cudaSuccess) return (int)e;
    known_smem = smem;
    known = n;
  }
  if (known < 1) return port::kNoClusterFits;
  cfg.gridDim = dim3(kCluster * B);
  e = cudaLaunchKernelEx(&cfg, fft_kernel<E>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Both entries: the plan's route, which must be the caller's `route`.
int run(const float* audio, const int* audio_len, int* feat_len, int route,
        const float* basis, int ld, const float* mel, const float* consts,
        const int* bands, const float* weights, const float* mean,
        const float* stdev, const long long* fw, const long long* fs, int nf,
        const long long* tw, const long long* ts, int nt, int time_width,
        float* out,
        int B, int S, int F, int win, int hop, int n_fft, int M,
        float log_floor, int cmvn, void* stream) {
  if (!valid_shape(B, S, F, win, hop, M, cmvn, mean, stdev) || n_fft < 2)
    return (int)cudaErrorInvalidValue;
  const FftPlan p = fe_fft_plan(F, win, hop, n_fft, M);
  if (route != p.route) return kRouteMismatch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SpecAug sa{fw, fs, nf, tw, ts, nt, time_width};
  if (p.route == kRouteSpectral)
    return run_spectral(audio, audio_len, feat_len, basis, ld, mel, sa, mean,
                        stdev, out, B, S, F, win, hop, n_fft / 2 + 1, M,
                        log_floor, cmvn, true, st);
  if (!consts || !bands || !weights ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const FftArgs a{audio, audio_len, feat_len, consts, bands,
                  reinterpret_cast<const float4*>(weights), out,
                  S, F, win, hop, n_fft, M, p.P, p.Q, cmvn, log_floor,
                  Epilogue{cmvn == kCmvnGlobal ? kNormGlobal : kNormNone,
                           mean, stdev, sa}};
  switch (n_fft) {
    case 128: return launch_fft<2>(a, B, p.smem, st);
    case 256: return launch_fft<4>(a, B, p.smem, st);
    case 512: return launch_fft<8>(a, B, p.smem, st);
    case 1024: return launch_fft<16>(a, B, p.smem, st);
    default: return launch_fft<32>(a, B, p.smem, st);
  }
}

#endif  // FE_FFT

}  // namespace

#if FE_FFT

// Plain C interface (loaded with ctypes). Device pointers: audio [B,S] f32;
// audio_len [B] int32; feat_len [B] int32, written (num_frames of each
// row's length); route: fe_fft_plan's for the shape (kRouteMismatch, -2,
// without launching otherwise). The spectral route's operands: basis
// [win, ld] f32, 16-byte aligned, frequency k's windowed (cos, sin) at
// columns 2k, 2k+1; mel [n_fft/2 + 1, M] f32. The FFT route's: consts
// [3 n_fft] f32, 16-byte aligned (the twiddles W^k = (cos, -sin)(2 pi k /
// n_fft), k < n_fft, then the window, zero past win); bands [M][3] int32
// and weights f32, 16-byte aligned (each mel's run of weights: its first
// bin and its offset in weights, multiples of 4, and the count of bins,
// a multiple of 4, that lie in [0, n_fft/2 + 4); the mel's nonzero
// weights at their bins, zeros elsewhere). The other route's operands
// may be null. mean,
// std [M] f32 (cmvn global, else may be null); the SpecAugment draws fw,
// fs [B, nf] and tw, ts [B, nt] int64 (nf = 0 / nt = 0 where off); out
// [B, F, M] f32. hop a multiple of 4. cmvn: 0 none, 1 global, 2
// utterance. Returns cudaGetLastError() after the launch (0 on success),
// or kNoClusterFits (-1) without launching.
//
// K5 and K6 compute the same function; each makes one launch a call on
// the FFT route (two on the spectral route with utterance CMVN).
extern "C" int frontend_k5(const float* audio, const int* audio_len,
                           int* feat_len, int route, const float* basis,
                           int ld, const float* mel, const float* consts,
                           const int* bands, const float* weights,
                           const float* mean, const float* stdev,
                           const long long* fw, const long long* fs, int nf,
                           const long long* tw, const long long* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_fft, int M,
                           float log_floor, int cmvn, void* stream) {
  return run(audio, audio_len, feat_len, route, basis, ld, mel, consts, bands,
             weights, mean, stdev, fw, fs, nf, tw, ts, nt, time_width, out, B,
             S, F, win, hop, n_fft, M, log_floor, cmvn, stream);
}

extern "C" int frontend_k6(const float* audio, const int* audio_len,
                           int* feat_len, int route, const float* basis,
                           int ld, const float* mel, const float* consts,
                           const int* bands, const float* weights,
                           const float* mean, const float* stdev,
                           const long long* fw, const long long* fs, int nf,
                           const long long* tw, const long long* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_fft, int M,
                           float log_floor, int cmvn, void* stream) {
  return run(audio, audio_len, feat_len, route, basis, ld, mel, consts, bands,
             weights, mean, stdev, fw, fs, nf, tw, ts, nt, time_width, out, B,
             S, F, win, hop, n_fft, M, log_floor, cmvn, stream);
}

#if FE_TIMING
// The FFT kernel's phase cycles summed over its CTAs since the last call
// (kPhases of them, then the count of CTAs), cleared.
extern "C" int frontend_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, fe_phase_cycles,
                                       sizeof(fe_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kPhases + 1] = {};
  return (int)cudaMemcpyToSymbol(fe_phase_cycles, zero, sizeof(zero));
}
#endif

// fe_fft_plan's answer for a shape: out = {route, P, Q, shared bytes}.
extern "C" int frontend_plan(int F, int win, int hop, int n_fft, int M,
                             int* out) {
  const FftPlan p = fe_fft_plan(F, win, hop, n_fft, M);
  out[0] = p.route;
  out[1] = p.P;
  out[2] = p.Q;
  out[3] = (int)p.smem;
  return 0;
}

#else  // FE_FFT 0: the first design's entries

namespace {

int run_first(const float* audio, const int* audio_len, int* feat_len,
              const float* basis, int ld, const float* mel, const float* mean,
              const float* stdev, const long long* fw, const long long* fs,
              int nf, const long long* tw, const long long* ts, int nt,
              int time_width, float* out, int B, int S, int F, int win,
              int hop, int n_freq,
              int M, float log_floor, int cmvn, bool utterance_kernel,
              void* stream) {
  if (!valid_shape(B, S, F, win, hop, M, cmvn, mean, stdev) || n_freq <= 0)
    return (int)cudaErrorInvalidValue;
  const SpecAug sa{fw, fs, nf, tw, ts, nt, time_width};
  return run_spectral(audio, audio_len, feat_len, basis, ld, mel, sa, mean,
                      stdev, out, B, S, F, win, hop, n_freq, M, log_floor,
                      cmvn, utterance_kernel, static_cast<cudaStream_t>(stream));
}

}  // namespace

// K5: for utterance CMVN, the spectral stage and cmvn_kernel.
extern "C" int frontend_k5(const float* audio, const int* audio_len,
                           int* feat_len,
                           const float* basis, int ld, const float* mel,
                           const float* mean, const float* stdev,
                           const long long* fw, const long long* fs, int nf,
                           const long long* tw, const long long* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_freq, int M,
                           float log_floor, int cmvn, void* stream) {
  return run_first(audio, audio_len, feat_len, basis, ld, mel, mean, stdev,
                   fw, fs, nf, tw, ts, nt, time_width, out, B, S, F, win, hop,
                   n_freq, M, log_floor, cmvn, true, stream);
}

// K6: for utterance CMVN, the raw log-mel (zero past feat_len); the caller
// finishes it.
extern "C" int frontend_k6(const float* audio, const int* audio_len,
                           int* feat_len,
                           const float* basis, int ld, const float* mel,
                           const float* mean, const float* stdev,
                           const long long* fw, const long long* fs, int nf,
                           const long long* tw, const long long* ts,
                           int nt, int time_width, float* out, int B, int S,
                           int F, int win, int hop, int n_freq, int M,
                           float log_floor, int cmvn, void* stream) {
  return run_first(audio, audio_len, feat_len, basis, ld, mel, mean, stdev,
                   fw, fs, nf, tw, ts, nt, time_width, out, B, S, F, win, hop,
                   n_freq, M, log_floor, cmvn, false, stream);
}

#endif  // FE_FFT

extern "C" const char* frontend_error_string(int code) {
  if (code == -2) return "the caller's route differs from fe_fft_plan's";
  if (code == port::kNoClusterFits)
    return "no cluster of the FFT kernel fits on the device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
