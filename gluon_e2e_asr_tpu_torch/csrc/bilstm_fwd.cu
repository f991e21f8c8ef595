// K1-fwd: one bidirectional LSTM layer, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gluon_e2e_asr_tpu/ops/pallas_lstm.py::bilstm_fused
// (forward: _v2_fwd_impl -> pl.pallas_call -> _v2_fwd_kernel). Same math:
//
//   xg  = x . w_x + b_x                  [B,T,8H]  f32 accumulation, inputs
//                                        rounded to the compute dtype
//   xg[..., 4H:] = 0 where t >= lens[b]  (backward half, as the TPU kernel)
//   per direction, gate order (i,f,g,o), forget bias +1 inside the cell:
//     gates = xg_t + h . W_h             h rounded to the compute dtype,
//                                        f32 accumulation
//     c' = sig(f+1)*c + sig(i)*tanh(g);  h' = sig(o)*tanh(c')
//   y = concat(fwd, bwd) [B,T,2H] f32, 0 at t >= lens[b]; the backward
//   direction sweeps t = T-1 .. 0 from zero state.
//
// Training form (a non-null c output): the recurrence also writes the c
// stream [B,T,2H] f32, and overwrites xg in place with the gate
// activations (sig(i), sig(f+1), tanh(g), sig(o)) in xg's layout, all 0
// at t >= lens[b]. K1-bwd (bilstm_bwd.cu) reads both, so it needs no gate
// recompute. The TPU kernel recomputes the gates instead
// (_v2_bwd_kernel); keeping them costs the xg buffer's B*T*8H*4 bytes
// from the forward to the backward (0.39 GB for the flagship's first
// layer at the 4.0 s bucket, B=96, T=398, H=320). Serving passes a null
// c output and runs exactly the kernel it ran before.
//
// Two kernels on the caller's stream, no allocation, no synchronisation:
//
//   (a) the projection, a tiled shared-memory GEMM (128x128 tile) that
//       writes xg with the bias added and the backward half masked. In
//       bf16, round_xg rounds xg to bf16 too (the lstm_impl=scan
//       semantics of models/encoder.py, where the projection is stored
//       in the compute dtype); in f32 that rounding changes nothing.
//       In f32, proj_f32_kernel: 8x8 outputs per thread on the FMA
//       units (true f32). In bf16, proj_bf16_kernel: the operands are
//       rounded to bf16 on their way to shared memory and multiplied on
//       the tensor cores (WMMA 16x16x16, f32 accumulation), the next
//       tile's global loads in flight during the current tile's product.
//   (b) recur_kernel: one persistent block per (direction, group of
//       kRows batch rows) loops over time. Thread u owns hidden unit u
//       for the block's rows: it accumulates the gate columns u, H+u, 2H+u
//       and 3H+u of h . W_h, so the cell update needs no exchange of gates
//       and c stays in registers. The caller passes W_h gate-interleaved
//       ([k][4u+g] = W_h[k][g*H+u]), so those four weights are one vector
//       load. h lives in shared memory, double buffered, so each step
//       needs one __syncthreads. No block needs another block's data: no
//       grid-wide sync.
//
// What bounds it on the card: the recurrence. Every step every block
// reads all of W_h (H x 4H: 0.8 MB in bf16 at H=320) from L2, and the
// step cannot start before the previous one finished, so the time per
// step is L2 bandwidth and latency plus kRows*H*4H FMAs on one SM. The
// design keeps the read coalesced and vectorized, keeps 16 rows of W_h
// loads in flight per thread against the L2 latency, reuses each weight
// for kRows rows and prefetches the step's xg before the product. The
// row-group size trades blocks in flight (L2 traffic) against FMAs per
// block: at the flagship shapes on an H100, 2 rows beat 1, 4 and 8.
// Keeping W_h resident in shared memory across a cluster (wgmma, TMA,
// distributed shared memory) is the route to a faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

using port::load4;
using port::round_bf16;
using port::sigmoid;

// ---------------------------------------------------------------------------
// (a) input projection
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kGemmThreads = 256;
constexpr int kPad = 4;  // keeps the transposed A tile free of bank conflicts

// The f32 projection on the FMA units.
__global__ void __launch_bounds__(kGemmThreads)
proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ lens,
                float* __restrict__ xg, int M, int N, int K, int T) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * kGemmThreads;
      const int r = idx / kBK, kk = idx % kBK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * kGemmThreads;
      const int kk = idx / kBN, c = idx % kBN;
      const int n = n0 + c, k = k0 + kk;
      Bs[kk][c] = (n < N && k < K) ? w[(size_t)k * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int half = N / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    const int b = m / T;
    const int t = m - b * T;
    const bool valid = t < lens[b];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (n >= half && !valid) v = 0.0f;
      xg[(size_t)m * N + n] = v;
    }
  }
}

// The bf16 projection on the tensor cores. 8 warps as 2 (rows) x 4
// (columns); each warp owns a 64x32 patch of the tile as 4x2 WMMA
// accumulators. VEC: x and w are 16-byte aligned and K % 4 == 0, so the
// tiles are fetched as float4.
constexpr int kTK = 32;                  // k per tile
constexpr int kLdA = kTK + 8;            // bf16 row pitch of the A tile
constexpr int kLdB = kBN + 8;            // bf16 row pitch of the B tile
constexpr int kLoads = kBM * kTK / kGemmThreads;  // 16 per operand

template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads, 2)
proj_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ lens,
                 float* __restrict__ xg, int M, int N, int K, int T,
                 int round_xg) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kTK][kLdB];
  __shared__ __align__(32) float Cs[kGemmThreads / 32][16 * 16];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // VEC: a thread's share of the next tile, in registers while the
  // current tile is multiplied. Consecutive threads read consecutive
  // addresses.
  float4 ra[kLoads / 4], rb[kLoads / 4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kLoads / 4; ++e) {
      const int idx = tid + e * kGemmThreads;
      const int am = m0 + idx / (kTK / 4), ak = k0 + 4 * (idx % (kTK / 4));
      ra[e] = (am < M && ak < K)
          ? *reinterpret_cast<const float4*>(x + (size_t)am * K + ak)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int bk = k0 + idx / (kBN / 4), bn = n0 + 4 * (idx % (kBN / 4));
      rb[e] = (bk < K && bn < N)
          ? *reinterpret_cast<const float4*>(w + (size_t)bk * N + bn)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int e = 0; e < kLoads / 4; ++e) {
      const int idx = tid + e * kGemmThreads;
      __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(
          &As[idx / (kTK / 4)][4 * (idx % (kTK / 4))]);
      a[0] = __floats2bfloat162_rn(ra[e].x, ra[e].y);
      a[1] = __floats2bfloat162_rn(ra[e].z, ra[e].w);
      __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(
          &Bs[idx / (kBN / 4)][4 * (idx % (kBN / 4))]);
      b[0] = __floats2bfloat162_rn(rb[e].x, rb[e].y);
      b[1] = __floats2bfloat162_rn(rb[e].z, rb[e].w);
    }
  };
  // Otherwise, element by element straight to shared memory.
  auto load_scalar = [&](int k0) {
    for (int e = 0; e < kLoads; ++e) {
      const int idx = tid + e * kGemmThreads;
      const int am = m0 + idx / kTK, ak = k0 + idx % kTK;
      As[idx / kTK][idx % kTK] = __float2bfloat16(
          (am < M && ak < K) ? x[(size_t)am * K + ak] : 0.0f);
      const int bk = k0 + idx / kBN, bn = n0 + idx % kBN;
      Bs[idx / kBN][idx % kBN] = __float2bfloat16(
          (bk < K && bn < N) ? w[(size_t)bk * N + bn] : 0.0f);
    }
  };

  if constexpr (VEC) fetch(0);
  for (int k0 = 0; k0 < K; k0 += kTK) {
    if constexpr (VEC) {
      stash();
    } else {
      load_scalar(k0);
    }
    __syncthreads();
    if constexpr (VEC) {
      if (k0 + kTK < K) fetch(k0 + kTK);
    }
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue, one 16x16 accumulator at a time through the warp's scratch.
  const int half = N / 2;
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 64 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < M && n < N) {
          const int b = m / T;
          float v = cs[e] + bias[n];
          if (n >= half && m - b * T >= lens[b]) v = 0.0f;
          xg[(size_t)m * N + n] = round_xg ? round_bf16(v) : v;
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// (b) recurrence
// ---------------------------------------------------------------------------

constexpr int kRows = 2;  // batch rows per recurrence block
constexpr int kUnroll = 16;

// acc[r][g] += h[r] * w_g for the block's rows; h is one unit's kRows
// values, adjacent in shared memory.
__device__ __forceinline__ void fma_rows(const float* h, const float4 w,
                                         float (&acc)[kRows][4]) {
  static_assert(kRows == 2, "h is read as one float2");
  const float2 hv = *reinterpret_cast<const float2*>(h);
  const float hr[kRows] = {hv.x, hv.y};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r][0] = fmaf(hr[r], w.x, acc[r][0]);
    acc[r][1] = fmaf(hr[r], w.y, acc[r][1]);
    acc[r][2] = fmaf(hr[r], w.z, acc[r][2]);
    acc[r][3] = fmaf(hr[r], w.w, acc[r][3]);
  }
}

// W_h comes gate-interleaved (see the header).
// Grid (ceil(B/kRows), 2): blockIdx.y is the direction. blockDim.x >= H.
// Dynamic shared memory: h as [2 buffers][H][kRows] f32 (already rounded
// to the compute dtype, since it only feeds the product).
// TRAIN (the training form): thread u also overwrites its four entries of
// xg at (b, t, dir) with the gate activations (si, sf, tg, so) and writes
// the c stream cs [B,T,2H]; both are 0 at t >= lens[b]. Each xg entry is
// read and written by the one thread that owns it.
template <typename WT, bool TRAIN>
__global__ void recur_kernel(float* __restrict__ xg,
                             const int* __restrict__ lens,
                             const WT* __restrict__ whf,
                             const WT* __restrict__ whb,
                             float* __restrict__ y, float* __restrict__ cs,
                             int B, int T, int H, int cd_bf16) {
  extern __shared__ __align__(16) float hs[];
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int u = threadIdx.x;
  const bool active = u < H;
  const WT* __restrict__ wh = dir ? whb : whf;
  const int H4 = 4 * H;
  const size_t xg_row = (size_t)8 * H;
  const size_t y_row = (size_t)2 * H;

  int len[kRows];
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    len[r] = (b0 + r < B) ? lens[b0 + r] : 0;
    c[r] = 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * H * kRows; i += blockDim.x) hs[i] = 0.0f;
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < T; ++s) {
    const int t = dir ? T - 1 - s : s;
    if (active) {
      // Prefetch this step's projections; they are consumed after the
      // product, so the loads overlap it.
      float xv[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (t < len[r]) {
          const float* xr = xg + (size_t)((b0 + r) * T + t) * xg_row + dir * H4;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = xr[g * H + u];
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = 0.0f;
        }
      }

      const float* hc = hs + cur * H * kRows;
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      // kUnroll rows of W_h per batch of loads: enough bytes in flight
      // per thread to cover the L2 latency.
      const WT* __restrict__ wu = wh + (size_t)4 * u;
      int k = 0;
      for (; k + kUnroll <= H; k += kUnroll) {
        float4 w[kUnroll];
#pragma unroll
        for (int kk = 0; kk < kUnroll; ++kk)
          w[kk] = load4(wu + (size_t)(k + kk) * H4);
#pragma unroll
        for (int kk = 0; kk < kUnroll; ++kk)
          fma_rows(hc + (k + kk) * kRows, w[kk], acc);
      }
      for (; k < H; ++k) fma_rows(hc + k * kRows, load4(wu + (size_t)k * H4), acc);

      float* hn = hs + (cur ^ 1) * H * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        float h_out = 0.0f;
        if (t < len[r]) {
          const float si = sigmoid(xv[r][0] + acc[r][0]);
          const float sf = sigmoid(xv[r][1] + acc[r][1] + 1.0f);
          const float tg = tanhf(xv[r][2] + acc[r][2]);
          const float so = sigmoid(xv[r][3] + acc[r][3]);
          const float cn = sf * c[r] + si * tg;
          h_out = so * tanhf(cn);
          c[r] = cn;
          hn[u * kRows + r] = cd_bf16 ? round_bf16(h_out) : h_out;
          if (TRAIN) {
            float* xr = xg + (size_t)(b * T + t) * xg_row + dir * H4;
            xr[u] = si;
            xr[H + u] = sf;
            xr[2 * H + u] = tg;
            xr[3 * H + u] = so;
            cs[(size_t)(b * T + t) * y_row + dir * H + u] = cn;
          }
        } else {
          hn[u * kRows + r] = hc[u * kRows + r];  // hold the state
          if (TRAIN && b < B) {
            float* xr = xg + (size_t)(b * T + t) * xg_row + dir * H4;
#pragma unroll
            for (int g = 0; g < 4; ++g) xr[g * H + u] = 0.0f;
            cs[(size_t)(b * T + t) * y_row + dir * H + u] = 0.0f;
          }
        }
        if (b < B) y[(size_t)(b * T + t) * y_row + dir * H + u] = h_out;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename WT>
cudaError_t launch_recur(float* xg, const int* lens, const void* whf,
                         const void* whb, float* y, float* cs, int B, int T,
                         int H, int cd_bf16, cudaStream_t stream) {
  // At most 16 KB (H <= 1024): under the 48 KB a launch gets without
  // cudaFuncSetAttribute.
  const size_t smem = sizeof(float) * 2 * (size_t)H * kRows;
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const int threads = ((H + 31) / 32) * 32;
  const WT* wf = static_cast<const WT*>(whf);
  const WT* wb = static_cast<const WT*>(whb);
  if (cs) {
    recur_kernel<WT, true><<<grid, threads, smem, stream>>>(
        xg, lens, wf, wb, y, cs, B, T, H, cd_bf16);
  } else {
    recur_kernel<WT, false><<<grid, threads, smem, stream>>>(
        xg, lens, wf, wb, y, cs, B, T, H, cd_bf16);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// whf/whb are float when cd_bf16 == 0 and __nv_bfloat16 when cd_bf16 == 1;
// xg is caller-allocated scratch [B,T,8H] f32. cs may be null (serving);
// otherwise it receives the c stream [B,T,2H] f32 and xg ends up holding
// the gate activations (the training form, see recur_kernel). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int bilstm_fwd(const float* x, const int* lens, const float* wx,
                          const float* bx, const void* whf, const void* whb,
                          float* xg, float* y, float* cs, int B, int T, int D,
                          int H, int cd_bf16, int round_xg, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || H <= 0 || H > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int N = 8 * H;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  if (cd_bf16 && vec) {
    proj_bf16_kernel<true><<<grid, kGemmThreads, 0, st>>>(
        x, wx, bx, lens, xg, M, N, D, T, round_xg);
  } else if (cd_bf16) {
    proj_bf16_kernel<false><<<grid, kGemmThreads, 0, st>>>(
        x, wx, bx, lens, xg, M, N, D, T, round_xg);
  } else {
    proj_f32_kernel<<<grid, kGemmThreads, 0, st>>>(x, wx, bx, lens, xg, M, N,
                                                   D, T);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cd_bf16 ? launch_recur<__nv_bfloat16>(xg, lens, whf, whb, y, cs, B, T,
                                            H, 1, st)
              : launch_recur<float>(xg, lens, whf, whb, y, cs, B, T, H, 0, st);
  return (int)e;
}

extern "C" const char* bilstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
