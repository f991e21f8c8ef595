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
// c output, and the recurrence writes y alone.
//
// K7-fwd (bilstm_v1_fwd below, the v1 layer of pallas_lstm.py::bilstm_pallas)
// is the recurrence (b) alone, reading the caller's projections xg_f, xg_b
// [B,T,4H] (f32 or bf16) instead of K1's xg buffer, and writing the
// activations to a buffer of its own; its h and c streams may be rounded
// to bf16, as the TPU kernel emits them in xg's dtype.
//
// Kernels on the caller's stream, no allocation, no synchronisation:
//
//   (a) the projection, which writes xg with the bias added and the
//       backward half masked (bilstm_fwd_proj alone, or first in
//       bilstm_fwd). In bf16, round_xg rounds xg to bf16 too (the
//       lstm_impl=scan semantics of models/encoder.py, where the
//       projection is stored in the compute dtype); in f32 that rounding
//       changes nothing. In f32, gemm_f32.cuh's ring_kernel on the FMA
//       units (true f32; that header has the design), its epilogue
//       (ProjEpi) adding the bias, masking the backward half and storing
//       16 bytes at a time; the backward half takes its rows live frames
//       first, so that its row tiles past the live frames skip the
//       product. proj_f32_kernel, the kernel it replaced,
//       is only a build variant (K1_F32_TILED 0) that tools/k1f_probe.py
//       --proj --dtype float32 times beside it. In bf16,
//       proj_sm90.cuh's proj_kernel: persistent and
//       warp-specialised on wgmma, x rounded in the consumers' registers,
//       W_x from the wrapper's bf16 copy by TMA, the epilogue's stores by
//       TMA (that header says why). proj_bf16_kernel, the WMMA kernel it
//       replaced, is only a build variant (K1F_WGMMA_PROJECTION 0) that
//       tools/k1f_probe.py --proj times beside it.
//   (b) the recurrence, chosen by shape alone: fwd_cluster_kernel for
//       H <= 320 (every config of the repo: 320 and 256), recur_kernel
//       for 320 < H <= 1024. A launch failure of either is returned and
//       the wrapper raises; neither replaces the other.
//
// fwd_cluster_kernel: W_h resident across a cluster of 16 CTAs.
//   One cluster of kCtas = 16 CTAs per (direction, group of R batch
//   rows). CTA r owns hidden units [rU, rU + U), U = cluster_units(H) =
//   4 * ceil(H / 64) (20 at H=320, 16 at H=256); units past H compute
//   nothing and their h stays 0. It owns the 4U gate columns of its
//   units, local column j = 4*lu + g for gate g of local unit lu, and
//   holds W_h's [16U x 4U] slice of them, [k][j] = W_h[k][g*H + rU + lu],
//   0 for k >= H or rU + lu >= H, in shared memory for all T steps. The
//   slice is the columns [4rU, 4rU + 4U) of the gate-interleaved W_h that
//   recur_kernel reads, padded; the wrapper ships the 16 slices as one
//   [16][16U][4U] tensor in the compute dtype
//   (ops/bilstm.py::_cluster_fwd_slices), and the prologue copies the
//   CTA's slice into shared memory with the k-block skew below, widened
//   to f32 (the compute dtype's values; 102,400 B at H=320). A bf16 slice
//   (51,200 B: one 16-byte load of W a k instead of two, and eight
//   conversions) made the product slower on the H100: 7.6 us a step
//   against 4.7 at the flagship's layer 0 (PERF.md, tools/k1f_probe.py
//   --ablate). Each CTA also holds the whole h of its rows, [2][16U][R]
//   f32 (double buffered, already rounded to the compute dtype: it only
//   feeds the product). Each step has three phases:
//   (a) product: gates[row][j] = sum_k h[row][k] * W[k][j] over the CTA's
//       4U columns, depth 16U, true f32 FMAs (no TF32). Thread i < R*U/4:
//       lane s = i % 4 takes the k-block [4Us, 4U(s+1)), tile i / 4 is 8
//       rows x 2 units x 4 gates (64 accumulators; a warp's tiles run
//       along the units): per k two 16-byte loads of h (its 8 rows, the
//       two tiles of a quarter-warp share them) and two of W, 64 FMAs,
//       as pipeline_probe.cu's cluster kernel. The
//       four lanes of a tile meet in a reduce-scatter of warp shuffles
//       (their partial sums added as (s0 + s2) + (s1 + s3)), after which
//       each lane holds the four gates of 4 rows of one unit: its cells.
//       The k-blocks are skewed in shared memory so that no quarter-warp
//       load hits a bank group twice (skew). The step's projections of
//       the lane's cells (4 rows x 4 gates, along the units of a warp)
//       are loaded before the product, so their latency hides behind it.
//   (b) cell: the formulas above, c in registers; past lens[b] the state
//       holds and every stream of the row gets 0 (the forward direction;
//       the backward one starts from zero state there, since the
//       projection zeroed its xg half). h', rounded to the compute dtype,
//       goes to the next h buffer of every CTA of the cluster, itself
//       included, one 16-byte store (4 rows) a destination through
//       cluster.map_shared_rank; y gets the unrounded h' (rounded only
//       with round_out, K7).
//   (c) one cluster barrier ends the step, split into its arrival and its
//       wait, with the step's stores of y (and, in the training form, of
//       the activations over xg and of c) between them. A warp's lanes
//       run along the units of a row, so each store instruction writes
//       runs of 64-80 contiguous bytes. The double buffer makes one
//       barrier a step enough: a buffer is written in step s + 1 only
//       after every CTA has passed the barrier of step s, and so has
//       finished step s's product, the last reader of that buffer.
//   The training form overwrites xg in place: the lane that loads an
//   entry of xg at (b, t) is the one that overwrites it at (b, t), after
//   the load; no other lane touches it, and later steps read other t.
//   Rows per cluster R: the fewest of 16, 32 and 48 for which the
//   2 * ceil(B / R) clusters fit on the card at once
//   (cudaOccupancyMaxActiveClusters, asked once per kernel, R and U),
//   else 48 in waves (common.cuh::cluster_rows, as K1-bwd): on the H100
//   B=96 takes 32, B=16 and B=1 16. Shared memory (16U*4U + 2*16U*R)*4 B,
//   plus 80 B of skew per array: 184,560 B at H=320, R=32 and 225,520 at
//   R=48, within the 232,448 a block may have for every H <= 320 and
//   R <= 48. When not even one cluster fits,
//   the launch returns kNoClusterFits.
//   One step at the flagship's layer shape (H=320, B=96, bf16, R=32: 6
//   clusters, 96 CTAs, one wave): 819,200 FMAs a CTA (32 x 320 x 80),
//   40,960 B stored through distributed shared memory a CTA (38,400 of
//   them to other CTAs), one cluster barrier and no CTA barrier; from
//   device memory 10,240 B of projections in and 2,560 B of y out a CTA
//   (the training form 15,360 B out with the activations and c).
//   What bounds it: shared memory in the product (4 loads per 64 FMAs, at
//   about 5 cycles per 16-byte load a warp on the H100), then the chain
//   of the step's phases: the reduce-scatter, the cell, the all-gather and
//   the barrier, none of which costs more than 0.5 us a step when cut
//   alone (PERF.md, tools/k1f_probe.py --ablate).
//
// recur_kernel (320 < H <= 1024): one persistent block per (direction,
//   group of kRows batch rows) loops over time. Thread u owns hidden unit
//   u for the block's rows: it accumulates the gate columns u, H+u, 2H+u
//   and 3H+u of h . W_h, so the cell update needs no exchange of gates and
//   c stays in registers. The caller passes W_h gate-interleaved
//   ([k][4u+g] = W_h[k][g*H+u]), so those four weights are one vector
//   load. h lives in shared memory, double buffered, so each step needs
//   one __syncthreads. Every step every block reads all of W_h from L2
//   (4 MB in bf16 at H=1024) and does kRows*H*4H FMAs, and a step cannot
//   start before the previous one ended.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"
#include "proj_sm90.cuh"

namespace cg = cooperative_groups;

// 1: the bf16 projection on wgmma (proj_sm90.cuh). 0 builds the WMMA
// kernel proj_bf16_kernel in its place: a build variant that
// tools/k1f_probe.py --proj times beside it, on no model path (the main
// build does not compile that kernel).
#define K1F_WGMMA_PROJECTION 1

// 1: the f32 projection on gemm_f32.cuh's ring_kernel. 0 builds its first
// kernel, proj_f32_kernel, in its place: a build variant that the probes
// time beside it, on no model path.
#define K1_F32_TILED 1

namespace {

using port::cluster_arrive;
using port::cluster_rows;
using port::cluster_units;
using port::cluster_wait;
using port::kClusterMaxHidden;
using port::kCtas;
using port::kMaxRows;
using port::kNoClusterFits;
using port::kRowStep;
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

#if K1_F32_TILED
// The f32 projection's epilogue on ring_kernel: xg[m][n] = v + bias[n], 0
// in the backward half (n >= half) of a frame past its length (m = b*T +
// t, t >= lens[b]); four columns a 16-byte store where vec.
struct ProjEpi {
  const float* bias;
  const int* lens;
  float* xg;
  int N, T, half;
  bool vec;  // gemm::vec_ok(xg, N)
  __device__ __forceinline__ bool dead(int m) const {
    const int b = m / T;
    return m - b * T >= __ldg(lens + b);
  }
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    xg[(size_t)m * N + n] = n >= half && dead(m) ? 0.0f : v + __ldg(bias + n);
  }
  __device__ __forceinline__ void four(int m, int n, float4 v, int cols) const {
    if (!vec || cols < 4) {
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < cols; ++i) (*this)(m, n + i, w[i]);
      return;
    }
    const bool zero = n >= half && dead(m);  // half % 4 == 0: 4H
    const float4 out = zero ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                            : make_float4(v.x + __ldg(bias + n),
                                          v.y + __ldg(bias + n + 1),
                                          v.z + __ldg(bias + n + 2),
                                          v.w + __ldg(bias + n + 3));
    *reinterpret_cast<float4*>(xg + (size_t)m * N + n) = out;
  }
};
#else
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
#endif  // K1_F32_TILED

#if !K1F_WGMMA_PROJECTION
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
#endif  // !K1F_WGMMA_PROJECTION

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where a recurrence block reads its projections and writes its streams.
// Row (b, t) of direction d's projections starts at (d ? xb : xf) +
// (b*T + t) * x_row: K1 passes its xg buffer (xf = xg, xb = xg + 4H,
// x_row = 8H), K7 its two inputs (x_row = 4H, f32 or bf16). acts is the
// training form's [B,T,8H] f32 activation stream: K1's xg buffer itself
// (each entry read, then overwritten, by the one thread that owns it, so
// xf and acts are not marked __restrict__), K7's own buffer. round_out
// rounds the y and c streams to bf16 (K7's streams in xg's dtype).
template <typename XT>
struct RecurIO {
  const XT* xf;
  const XT* xb;
  int x_row;
  float* acts;
  float* cs;
  int round_out;
};

// W_h comes gate-interleaved (see the header).
// Grid (ceil(B/kRows), 2): blockIdx.y is the direction. blockDim.x >= H.
// Dynamic shared memory: h as [2 buffers][H][kRows] f32 (already rounded
// to the compute dtype, since it only feeds the product).
// TRAIN (the training form): thread u also writes its four entries of
// acts at (b, t, dir) with the gate activations (si, sf, tg, so) and the
// c stream cs [B,T,2H]; both are 0 at t >= lens[b].
template <typename WT, typename XT, bool TRAIN>
__global__ void recur_kernel(RecurIO<XT> io, const int* __restrict__ lens,
                             const WT* __restrict__ whf,
                             const WT* __restrict__ whb,
                             float* __restrict__ y, int B, int T, int H,
                             int cd_bf16) {
  extern __shared__ __align__(16) float hs[];
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int u = threadIdx.x;
  const bool active = u < H;
  const WT* __restrict__ wh = dir ? whb : whf;
  const XT* xd = dir ? io.xb : io.xf;
  const int H4 = 4 * H;
  const size_t a_row = (size_t)8 * H;
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
          const XT* xr = xd + (size_t)((b0 + r) * T + t) * io.x_row;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[r][g] = to_float(xr[g * H + u]);
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
            float* ar = io.acts + (size_t)(b * T + t) * a_row + dir * H4;
            ar[u] = si;
            ar[H + u] = sf;
            ar[2 * H + u] = tg;
            ar[3 * H + u] = so;
            io.cs[(size_t)(b * T + t) * y_row + dir * H + u] =
                io.round_out ? round_bf16(cn) : cn;
          }
        } else {
          hn[u * kRows + r] = hc[u * kRows + r];  // hold the state
          if (TRAIN && b < B) {
            float* ar = io.acts + (size_t)(b * T + t) * a_row + dir * H4;
#pragma unroll
            for (int g = 0; g < 4; ++g) ar[g * H + u] = 0.0f;
            io.cs[(size_t)(b * T + t) * y_row + dir * H + u] = 0.0f;
          }
        }
        if (b < B)
          y[(size_t)(b * T + t) * y_row + dir * H + u] =
              io.round_out ? round_bf16(h_out) : h_out;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// ---------------------------------------------------------------------------
// (c) fwd_cluster_kernel: W_h resident across a cluster (see the header)
// ---------------------------------------------------------------------------

constexpr int kRT = 8;              // rows of a product tile
constexpr int kUT = 2;              // units of a product tile
constexpr int kKS = 4;              // k split over 4 adjacent lanes
constexpr int kClThreadsMax = 256;  // kMaxRows * 20 / 4 = 240, in warps

// k-block s (k in [s*4U, (s+1)*4U), the depth of one lane) of h and of
// the W slice starts skew(s) words further, so that a quarter-warp's
// 16-byte loads hit eight distinct 16-byte bank groups: the blocks start 0
// mod 128 bytes apart, the skews put them at groups {0, 1, 4, 5}, and the
// two tiles of a quarter-warp are two groups apart in W and read the same
// h.
constexpr int kSkewMax = 20;  // skew(kKS - 1)
__device__ __forceinline__ int skew(int s) { return 4 * (s & 1) + 16 * (s >> 1); }

// Grid kCtas * groups * 2 blocks, clusters of kCtas along x: cluster
// id = blockIdx.x / kCtas is direction id / groups, rows
// [R * (id % groups), +R). wsf/wsb: the [kCtas][16U][4U] slices of W_h
// (ops/bilstm.py::_cluster_fwd_slices) of the two directions, in WT.
// Dynamic shared memory, f32 words: this CTA's slice as [16U][4U] (the
// compute dtype's values), then h as [2 buffers][16U][R], each k-block s
// skewed by skew(s) words, each array kSkewMax words longer.
//
// Lane l of warp v, thread i = 32v + l < R*U/4: k-block s = i % 4, tile
// g = i / 4 of rows 8 * (g / (U/2)) .. +7 and local units
// 2 * (g % (U/2)), +1, so that a warp's tiles run along the units. The
// four lanes of a tile meet in a reduce-scatter of shuffles, after which
// lane s holds the 4 gates of local unit 2 * (g % (U/2)) + s / 2 for rows
// 8 * (g / (U/2)) + 4 * (s % 2) .. +3: its cells, c in registers.
template <typename WT, typename XT, bool TRAIN>
__global__ void __launch_bounds__(kClThreadsMax, 1)
fwd_cluster_kernel(RecurIO<XT> io, const int* __restrict__ lens,
                   const WT* __restrict__ wsf, const WT* __restrict__ wsb,
                   float* __restrict__ y, int B, int T, int H, int R,
                   int groups, int cd_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int id = blockIdx.x / kCtas;
  const int dir = id / groups;
  const int b0 = (id % groups) * R;
  const int U = cluster_units(H);
  const int Hp = kCtas * U;       // padded units: the product's depth
  const int J = 4 * U;            // this CTA's gate columns
  const int KB = Hp / kKS;        // depth of one lane
  const int active = R * U / 4;   // threads with a tile and cells
  const int hwords = Hp * R + kSkewMax;  // one h buffer
  const int H4 = 4 * H;
  const size_t a_row = (size_t)8 * H;  // acts: [B,T,8H]
  const size_t y_row = (size_t)2 * H;  // y and cs: [B,T,2H]
  const int tid = threadIdx.x;
  float* ws = reinterpret_cast<float*>(smem);
  float* hs = ws + Hp * J + kSkewMax;
  const XT* xd = dir ? io.xb : io.xf;

  // This CTA's slice of W_h, four weights a load, widened to f32 (a bf16
  // slice in shared memory makes the product slower: see the header),
  // each k-block skewed.
  {
    const WT* src = (dir ? wsb : wsf) + (size_t)rank * Hp * J;
    const int per_row = J / 4;
    for (int i = tid; i < Hp * per_row; i += blockDim.x) {
      const int k = i / per_row, c = 4 * (i % per_row);
      *reinterpret_cast<float4*>(ws + k * J + skew(k / KB) + c) =
          load4(src + (size_t)k * J + c);
    }
  }
  // Both h buffers start at 0: padded units and rows past B stay 0.
  for (int i = tid; i < 2 * hwords; i += blockDim.x) hs[i] = 0.0f;

  const bool on = tid < active;
  const int warp = tid / 32;
  const int s = tid % kKS;
  const int g = tid / kKS;
  const int pairs = U / kUT;
  const int oct = g / pairs, pair = g % pairs;
  const int b1 = s >> 1, bl = s & 1;
  const int lu = kUT * pair + b1;        // local unit of this lane's cells
  const int ug = rank * U + lu;          // and its padded unit
  const int row0 = kRT * oct + 4 * bl;   // and its first row
  const int live_lanes = active - warp * 32;
  const unsigned mask =
      live_lanes >= 32 ? 0xffffffffu : (1u << max(live_lanes, 0)) - 1u;
  const bool unit_live = on && ug < H;

  int len[4];
  float c[4], hr[4];  // c, and h as the buffers hold it (rounded)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + row0 + r;
    len[r] = (unit_live && b < B) ? lens[b] : 0;
    c[r] = 0.0f;
    hr[r] = 0.0f;
  }
  const float* wp = ws + KB * s * J + skew(s) + 4 * kUT * pair;
  const int hp = KB * s * R + skew(s) + kRT * oct;
  // Every CTA of the cluster has started and filled its buffers before
  // any CTA stores into another's.
  cluster.sync();

  // This step's outputs of the lane's cells, stored while the cluster
  // gathers at the barrier.
  float yo[4], co[4], ao[4][4];
  for (int step = 0; step < T; ++step) {
    const int t = dir ? T - 1 - step : step;
    const int cur = step & 1;
    if (on) {
      // (b)'s projections, loaded now so that their latency hides behind
      // the product.
      float xv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (t < len[r]) {
          const XT* xr = xd + (size_t)((b0 + row0 + r) * T + t) * io.x_row + ug;
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[r][q] = to_float(xr[q * H]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[r][q] = 0.0f;
        }
      }
      // (a) product: this lane's k-block of the tile's 8 rows x 8 columns.
      const float* hc = hs + cur * hwords + hp;
      float acc[kUT][kRT][4];
#pragma unroll
      for (int u = 0; u < kUT; ++u)
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[u][r][q] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < KB; ++j) {
        const float4 ha = *reinterpret_cast<const float4*>(hc + j * R);
        const float4 hb = *reinterpret_cast<const float4*>(hc + j * R + 4);
        const float4 wu[kUT] = {*reinterpret_cast<const float4*>(wp + j * J),
                                *reinterpret_cast<const float4*>(wp + j * J + 4)};
        const float hv[kRT] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int u = 0; u < kUT; ++u) {
#pragma unroll
          for (int r = 0; r < kRT; ++r) {
            acc[u][r][0] = fmaf(hv[r], wu[u].x, acc[u][r][0]);
            acc[u][r][1] = fmaf(hv[r], wu[u].y, acc[u][r][1]);
            acc[u][r][2] = fmaf(hv[r], wu[u].z, acc[u][r][2]);
            acc[u][r][3] = fmaf(hv[r], wu[u].w, acc[u][r][3]);
          }
        }
      }
      // Reduce-scatter over the tile's four lanes: lane s keeps unit s / 2
      // (xor 2), then rows 4 * (s % 2) .. +3 of it (xor 1).
      float part[kRT * 4];
#pragma unroll
      for (int i = 0; i < kRT * 4; ++i) {
        const float a0 = acc[0][i / 4][i % 4], a1 = acc[1][i / 4][i % 4];
        part[i] = (b1 ? a1 : a0) + __shfl_xor_sync(mask, b1 ? a0 : a1, 2);
      }
      float gates[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float lo = part[i], hi = part[16 + i];
        gates[i] = (bl ? hi : lo) + __shfl_xor_sync(mask, bl ? lo : hi, 1);
      }
      // (b) cell: the same formulas as recur_kernel; past lens the state
      // holds and every stream gets 0.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (t < len[r]) {
          const float si = sigmoid(xv[r][0] + gates[4 * r]);
          const float sf = sigmoid(xv[r][1] + gates[4 * r + 1] + 1.0f);
          const float tg = tanhf(xv[r][2] + gates[4 * r + 2]);
          const float so = sigmoid(xv[r][3] + gates[4 * r + 3]);
          const float cn = sf * c[r] + si * tg;
          const float h_out = so * tanhf(cn);
          c[r] = cn;
          hr[r] = cd_bf16 ? round_bf16(h_out) : h_out;
          yo[r] = io.round_out ? round_bf16(h_out) : h_out;
          co[r] = io.round_out ? round_bf16(cn) : cn;
          ao[r][0] = si;
          ao[r][1] = sf;
          ao[r][2] = tg;
          ao[r][3] = so;
        } else {
          yo[r] = co[r] = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) ao[r][q] = 0.0f;
        }
      }
      // All-gather: this lane's 4 rows of unit ug into the next h buffer
      // of every CTA of the cluster, itself included.
      const float4 hv4 = make_float4(hr[0], hr[1], hr[2], hr[3]);
      float* dst = hs + (cur ^ 1) * hwords + ug * R + skew(ug / KB) + row0;
#pragma unroll
      for (int k = 0; k < kCtas; ++k)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, k)) = hv4;
    }
    cluster_arrive();
    if (unit_live) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = b0 + row0 + r;
        if (b >= B) continue;
        const size_t bt = (size_t)b * T + t;
        y[bt * y_row + dir * H + ug] = yo[r];
        if (TRAIN) {
          float* ar = io.acts + bt * a_row + dir * H4 + ug;
#pragma unroll
          for (int q = 0; q < 4; ++q) ar[q * H] = ao[r][q];
          io.cs[bt * y_row + dir * H + ug] = co[r];
        }
      }
    }
    cluster_wait();
  }
}

size_t fwd_cluster_smem(int R, int U) {
  const size_t Hp = (size_t)kCtas * U;
  return sizeof(float) * (Hp * 4 * U + kSkewMax + 2 * (Hp * R + kSkewMax));
}

// Clusters of fwd_cluster_kernel<WT, XT, TRAIN> with R rows at U units the
// device holds at once, asked once per (R, U) and process.
template <typename WT, typename XT, bool TRAIN>
cudaError_t fwd_capacity(int R, int U, cudaStream_t st, int* clusters) {
  static int known[kMaxRows / kRowStep][kClusterMaxHidden / 16 / 4 + 1] = {};
  return port::cluster_capacity(fwd_cluster_kernel<WT, XT, TRAIN>,
                                fwd_cluster_smem(R, U), R * U / 4, st,
                                known[R / kRowStep - 1][U / 4], clusters);
}

template <typename WT, typename XT, bool TRAIN>
int launch_fwd_cluster(const RecurIO<XT>& io, const int* lens,
                       const void* wsf, const void* wsb, float* y, int B,
                       int T, int H, int cd_bf16, cudaStream_t st) {
  const int U = cluster_units(H);
  int R = 0, capacity = 0;
  cudaError_t e = cluster_rows(
      B,
      [&](int r, int* n) { return fwd_capacity<WT, XT, TRAIN>(r, U, st, n); },
      &R, &capacity);
  if (e != cudaSuccess) return (int)e;
  if (capacity < 1) return kNoClusterFits;
  const int groups = (B + R - 1) / R;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = port::cluster_config(fwd_cluster_kernel<WT, XT, TRAIN>,
                           fwd_cluster_smem(R, U), R * U / 4, groups, st,
                           &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, fwd_cluster_kernel<WT, XT, TRAIN>, io, lens,
                         static_cast<const WT*>(wsf),
                         static_cast<const WT*>(wsb), y, B, T, H, R, groups,
                         cd_bf16);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The recurrence, chosen by shape alone: fwd_cluster_kernel for
// H <= kClusterMaxHidden (whf/whb the _cluster_fwd_slices layout), else
// recur_kernel (whf/whb gate-interleaved). A failure of either is
// returned; neither replaces the other.
template <typename WT, typename XT>
int launch_recur(const RecurIO<XT>& io, const int* lens, const void* whf,
                 const void* whb, float* y, int B, int T, int H, int cd_bf16,
                 cudaStream_t stream) {
  if (H <= kClusterMaxHidden) {
    return io.cs
        ? launch_fwd_cluster<WT, XT, true>(io, lens, whf, whb, y, B, T, H,
                                           cd_bf16, stream)
        : launch_fwd_cluster<WT, XT, false>(io, lens, whf, whb, y, B, T, H,
                                            cd_bf16, stream);
  }
  // At most 16 KB (H <= 1024): under the 48 KB a launch gets without
  // cudaFuncSetAttribute.
  const size_t smem = sizeof(float) * 2 * (size_t)H * kRows;
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const int threads = ((H + 31) / 32) * 32;
  const WT* wf = static_cast<const WT*>(whf);
  const WT* wb = static_cast<const WT*>(whb);
  if (io.cs) {
    recur_kernel<WT, XT, true><<<grid, threads, smem, stream>>>(
        io, lens, wf, wb, y, B, T, H, cd_bf16);
  } else {
    recur_kernel<WT, XT, false><<<grid, threads, smem, stream>>>(
        io, lens, wf, wb, y, B, T, H, cd_bf16);
  }
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_recur_cd(const RecurIO<XT>& io, const int* lens, const void* whf,
                    const void* whb, float* y, int B, int T, int H,
                    int cd_bf16, cudaStream_t st) {
  return cd_bf16
      ? launch_recur<__nv_bfloat16, XT>(io, lens, whf, whb, y, B, T, H, 1, st)
      : launch_recur<float, XT>(io, lens, whf, whb, y, B, T, H, 0, st);
}

// The projection into xg [B,T,8H] (see the header): f32 on the FMA
// units, bf16 on wgmma (x with rows of ldx floats, wt16 the scratch
// [8H][ldw] for bf16(W_x)^T).
int launch_projection(const float* x, int ldx, const int* lens,
                      const float* wx, __nv_bfloat16* wt16, int ldw,
                      const float* bx, float* xg, int B, int T, int D, int H,
                      int cd_bf16, int round_xg, cudaStream_t st) {
  const int M = B * T;
  const int N = 8 * H;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (!cd_bf16) {
    if (ldx != D) return (int)cudaErrorInvalidValue;
#if K1_F32_TILED
    // the backward half's rows live frames first: its tiles past them
    // skip the product
    return (int)gemm_f32::launch(
        gemm::RowMajor{x, D, M, D, gemm::vec_ok(x, D)},
        gemm::RowMajor{wx, N, D, N, gemm::vec_ok(wx, N)},
        ProjEpi{bx, lens, xg, N, T, 4 * H, gemm::vec_ok(xg, N)}, M, N, D, 1,
        gemm_f32::Frames{}, gemm_f32::LiveRows{lens, T, 4 * H}, nullptr, st);
#else
    proj_f32_kernel<<<grid, kGemmThreads, 0, st>>>(x, wx, bx, lens, xg, M, N,
                                                   D, T);
    return (int)cudaGetLastError();
#endif
  }
#if K1F_WGMMA_PROJECTION
  if (wt16 == nullptr || ldx % 4 || ldw % 8 || ldw < D) {
    return (int)cudaErrorInvalidValue;
  }
  return proj_sm90::launch_proj(x, ldx, wx, wt16, ldw, bx, lens, xg, M, N, D,
                                T, round_xg, st);
#else
  if (ldx != D) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  if (vec) {
    proj_bf16_kernel<true><<<grid, kGemmThreads, 0, st>>>(
        x, wx, bx, lens, xg, M, N, D, T, round_xg);
  } else {
    proj_bf16_kernel<false><<<grid, kGemmThreads, 0, st>>>(
        x, wx, bx, lens, xg, M, N, D, T, round_xg);
  }
  return (int)cudaGetLastError();
#endif
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// whf/whb are W_h in the layout of the recurrence kernel that H selects
// (the header: the [16][16U][4U] slices for H <= 320, gate-interleaved
// [H][4H] above), float when cd_bf16 == 0 and __nv_bfloat16 when
// cd_bf16 == 1; xg is caller-allocated scratch [B,T,8H] f32. x [B,T,D]
// has rows of ldx floats (ldx = D in f32; a multiple of 4 >= D in bf16);
// wx [D,8H] f32; in bf16 wt16 is scratch [8H][ldw] (ldw a multiple of 8
// >= D) that receives W_x's bf16 copy, laid out as W_x^T. cs may be null
// (serving); otherwise it receives the c stream [B,T,2H] f32 and xg ends
// up holding the gate activations (the training form). Returns
// cudaGetLastError() after the launches (0 on success), kNoClusterFits
// (-1) without launching the recurrence when no cluster of it fits, or
// kNoTensorMap (-2) when cuTensorMapEncodeTiled refuses a tensor map of
// the bf16 projection.
extern "C" int bilstm_fwd(const float* x, const int* lens, const float* wx,
                          void* wt16, const float* bx, const void* whf,
                          const void* whb, float* xg, float* y, float* cs,
                          int B, int T, int D, int H, int ldx, int ldw,
                          int cd_bf16, int round_xg, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || H <= 0 || H > 1024 || ldx < D) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_projection(
      x, ldx, lens, wx, static_cast<__nv_bfloat16*>(wt16), ldw, bx, xg,
      B, T, D, H, cd_bf16, round_xg, st);
  if (rc != 0) return rc;
  const RecurIO<float> io{xg, xg + 4 * H, 8 * H, xg, cs, 0};
  return launch_recur_cd(io, lens, whf, whb, y, B, T, H, cd_bf16, st);
}

// K1-fwd's projection alone: xg [B,T,8H] f32 as bilstm_fwd forms it
// before its recurrence, from the arguments of the same names. Returns
// what bilstm_fwd returns for its projection.
extern "C" int bilstm_fwd_proj(const float* x, const int* lens,
                               const float* wx, void* wt16,
                               const float* bx, float* xg, int B, int T,
                               int D, int H, int ldx, int ldw, int cd_bf16,
                               int round_xg, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || H <= 0 || ldx < D) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_projection(x, ldx, lens, wx,
                           static_cast<__nv_bfloat16*>(wt16), ldw, bx,
                           xg, B, T, D, H, cd_bf16, round_xg,
                           static_cast<cudaStream_t>(stream));
}

// K1-fwd's recurrence alone, over an xg buffer [B,T,8H] f32 that the
// projection of bilstm_fwd filled (for timing the recurrence apart from
// the projection). The other arguments as bilstm_fwd's of the same names;
// with a non-null cs, xg ends up holding the gate activations. Returns
// what bilstm_fwd returns.
extern "C" int bilstm_fwd_recur(float* xg, const int* lens, const void* whf,
                                const void* whb, float* y, float* cs, int B,
                                int T, int H, int cd_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const RecurIO<float> io{xg, xg + 4 * H, 8 * H, xg, cs, 0};
  return launch_recur_cd(io, lens, whf, whb, y, B, T, H, cd_bf16,
                         static_cast<cudaStream_t>(stream));
}

// K7-fwd: the recurrence alone, over given projections (v1 layer,
// gluon_e2e_asr_tpu/ops/pallas_lstm.py::bilstm_pallas -> _bilstm_fwd_impl
// -> pl.pallas_call -> _fwd_kernel). xf, xb [B,T,4H] are float when
// x_bf16 == 0 and __nv_bfloat16 when x_bf16 == 1; whf/whb as for
// bilstm_fwd. y [B,T,2H] f32; cs and acts null (inference) or the c stream
// [B,T,2H] f32 and the gate activations [B,T,8H] f32 (training, for
// bilstm_v1_bwd). round_out rounds y and cs to bf16: the TPU kernel emits
// its h and c streams in xg's dtype. Returns cudaGetLastError().
extern "C" int bilstm_v1_fwd(const void* xf, const void* xb, const int* lens,
                             const void* whf, const void* whb, float* y,
                             float* cs, float* acts, int B, int T, int H,
                             int cd_bf16, int x_bf16, int round_out,
                             void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 1024 || (cs == nullptr) != (acts == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const RecurIO<__nv_bfloat16> io{static_cast<const __nv_bfloat16*>(xf),
                                    static_cast<const __nv_bfloat16*>(xb),
                                    4 * H, acts, cs, round_out};
    return launch_recur_cd(io, lens, whf, whb, y, B, T, H, cd_bf16, st);
  }
  const RecurIO<float> io{static_cast<const float*>(xf),
                          static_cast<const float*>(xb), 4 * H, acts, cs,
                          round_out};
  return launch_recur_cd(io, lens, whf, whb, y, B, T, H, cd_bf16, st);
}

// The plan fwd_cluster_kernel takes in K1-fwd's training form (f32
// projections) for B rows at hidden size H <= kClusterMaxHidden, weights
// in f32 (cd_bf16 == 0) or bf16: *R rows a cluster (common.cuh::
// cluster_rows) and *capacity, the clusters of R rows the device holds at
// once; the launch takes 2 * ceil(B / R) clusters of kCtas CTAs. For the
// record only: a launch asks the same itself. Returns a cudaError_t.
extern "C" int bilstm_fwd_cluster_plan(int* R, int* capacity, int B, int H,
                                       int cd_bf16, void* stream) {
  if (B <= 0 || H <= 0 || H > kClusterMaxHidden) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int U = cluster_units(H);
  return (int)cluster_rows(
      B,
      [&](int r, int* n) {
        return cd_bf16 ? fwd_capacity<__nv_bfloat16, float, true>(r, U, st, n)
                       : fwd_capacity<float, float, true>(r, U, st, n);
      },
      R, capacity);
}

extern "C" const char* bilstm_error_string(int code) {
  if (code == kNoClusterFits) {
    return "no cluster of 16 CTAs of fwd_cluster_kernel fits on this device "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  }
  if (code == proj_sm90::kNoTensorMap) {
    return "cuTensorMapEncodeTiled refused a tensor map of the bf16 "
           "projection";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
