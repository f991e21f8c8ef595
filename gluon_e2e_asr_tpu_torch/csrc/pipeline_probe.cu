// P1: N independent f32 LSTM recurrence chains over T steps, for Hopper
// (sm_90a). Two designs of one persistent recurrence, so that they can be
// timed against each other before K1's recurrence is rewritten.
//
// Replaces the TPU kernel tools/pipeline_probe.py::make_probe (kernel :53,
// pallas_call :80). Same math, per chain n and step (h, c [M,H] f32,
// W [H,4H] f32, H = 320, columns [i | f | o | g], no forget bias):
//
//   g = h . W                       true f32 on the FMA units (no TF32)
//   c' = sig(f)*c + sig(i)*tanh(g);  h' = sig(o)*tanh(c')
//
// and each chain's h after T steps is written to out [N,M,H]. The TPU
// kernel keeps everything in VMEM and interleaves the N chains in one
// instruction stream; a loop over T inside a persistent kernel takes the
// place of its fori_loop.
//
// Both kernels take W gate-interleaved: wi[n][k][4u+q] = W[n][k][q*H+u]
// with q over (i, f, o, g), so the four gate weights of hidden unit u for
// one k are one 16-byte load, and the thread that owns unit u updates its
// cell without exchanging gates. (K1's W_h is interleaved the same way,
// but its gates run (i, f, g, o) with +1 on f: the cell code differs.)
//
// (a) l2_kernel: K1's recurrence design (csrc/bilstm_fwd.cu::recur_kernel),
//     the baseline. One block per group of kRowsL2 rows carries all N
//     chains; thread u owns hidden unit u. Each step it starts the N
//     chains' products back to back, W read from L2 every step (16 rows of
//     loads in flight per thread), then the N chains' gates: the direct
//     counterpart of the TPU kernel's one stream of interleaved chains.
//     h is double-buffered in shared memory (one __syncthreads a step), c
//     stays in registers. kRowsL2 = 2: at the flagship's 96 rows K1's
//     recurrence was measured on the H100 with 2 rows a block faster than
//     with 1, 4 or 8 (PERF.md); at M=96 that is 48 blocks, each with an SM
//     of its own.
//     What bounds it: every block reads N * 1.64 MB of W from L2 every
//     step, and no step can start before the last one ended, so a step
//     costs the L2 read rate of one SM (and of the whole L2 once enough
//     blocks run) plus N * kRowsL2 * 409,600 FMAs on one SM. The card's
//     operation bound at M=96, N=1 is 1.2 us a step; the L2 read alone
//     takes about ten times that.
//
// (b) cluster_kernel: the design planned for K1. One cluster of kCtas = 16
//     CTAs per (chain, group of up to kRowsCl = 48 rows) keeps that chain's
//     W resident in shared memory, split by hidden unit: CTA r owns units
//     [20r, 20r + 20), i.e. W's 80 gate columns of those units (320 x 80 x
//     4 B = 102,400 B, and 80 B of skew). Each step a CTA multiplies the
//     whole h [48,320] by its slice, updates the cells of its units
//     locally, and publishes its slice of h' to every CTA of the cluster
//     through distributed shared memory (cluster.map_shared_rank, one
//     16-byte store a lane and destination); one cluster barrier ends the
//     step. h is double-buffered ([2][H][kRowsCl], 2 x 61,520 B with the
//     skew below), so one barrier a step suffices: a buffer is written in
//     step t only after every CTA left step t-1, the last step that read
//     it.
//     Why 16 CTAs and 48 rows: W in f32 is 1.64 MB, so 8 portable CTAs
//     would hold 204,800 B each and leave 27,648 B of the 232,448 a block
//     may have, room for a single-buffered h of 21 rows (two barriers a
//     step). 16 CTAs (cudaFuncAttributeNonPortableClusterSizeAllowed,
//     launched with cudaLaunchKernelEx) leave room for a double-buffered h
//     of 48 rows: 225,520 B in all. The launch refuses, and the wrapper
//     raises, when cudaOccupancyMaxActiveClusters finds no place for such
//     a cluster; it never falls back to another size.
//     Register tile: shared memory serves a 16-byte load one quarter-warp
//     at a time (4 wavefronts a warp, broadcast or not), against 4 warp
//     FMA instructions a cycle, so a thread must do 16 FMAs per 16-byte
//     load for the FMA pipes, not shared memory, to set the pace. A
//     thread's tile is 8 rows x 2 units x 4 gates (64 accumulators): per k
//     two float4 of h (its 8 rows, [k][row] layout) and two of W (its
//     units' gates) for 64 FMAs. To keep 240 threads with that tile, k is
//     split over the 4 adjacent lanes of a tile (80 k each), whose partial
//     sums meet in a reduce-scatter of warp shuffles; the k-blocks are
//     skewed in shared memory so that no quarter-warp's load hits a bank
//     twice. (A 4 x 1 tile without the split, 8 FMAs per load, ran the
//     product at about 60 cycles per k instead of 30.)
//     What bounds it: the FMA rate of one SM, with shared memory as busy
//     (16 wavefronts per 64 FMA instructions a warp). A CTA does 48 x 80 x
//     320 = 1.23 M FMAs a step (9,600 cycles at 128 a cycle), then the
//     reduce-scatter, the exchange (61 KB out of each CTA a step) and the
//     barrier. It uses 16 SMs per 48 rows of one chain, so at M=96, N=1 it
//     runs on 32 of the 132 SMs, at best 4.1x the card's bound; chains run
//     in clusters of their own, so N chains overlap only as far as the
//     card holds their clusters at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using port::load4;
using port::sigmoid;

constexpr int H = 320;
constexpr int H4 = 4 * H;

// ---------------------------------------------------------------------------
// (a) W from L2 (K1's design)
// ---------------------------------------------------------------------------

constexpr int kRowsL2 = 2;
constexpr int kUnroll = 16;
constexpr int kMaxChains = 4;
static_assert(H % kUnroll == 0, "the product loop has no remainder");

// Grid ceil(M / kRowsL2) blocks of H threads; all chains in every block.
// One block an SM is all the grid needs, so the compiler may spend up to
// 204 registers a thread on loads in flight.
template <int N>
__global__ void __launch_bounds__(H, 1)
l2_kernel(const float* __restrict__ h0, const float* __restrict__ c0,
          const float* __restrict__ wi, float* __restrict__ out, int M, int T) {
  __shared__ __align__(16) float hs[2][N][H][kRowsL2];
  const int u = threadIdx.x;
  const int m0 = blockIdx.x * kRowsL2;

  float c[N][kRowsL2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int r = 0; r < kRowsL2; ++r) {
      const int m = m0 + r;
      const size_t at = ((size_t)n * M + m) * H + u;
      hs[0][n][u][r] = m < M ? h0[at] : 0.0f;  // rows past M stay 0
      c[n][r] = m < M ? c0[at] : 0.0f;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float acc[N][kRowsL2][4];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < kRowsL2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][r][q] = 0.0f;
    // The N products back to back, before any gate.
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float* hc = &hs[cur][n][0][0];
      const float* __restrict__ wu = wi + (size_t)n * H * H4 + 4 * u;
      for (int k = 0; k < H; k += kUnroll) {
        float4 w[kUnroll];
#pragma unroll
        for (int kk = 0; kk < kUnroll; ++kk) w[kk] = load4(wu + (size_t)(k + kk) * H4);
#pragma unroll
        for (int kk = 0; kk < kUnroll; ++kk) {
          const float2 hv = *reinterpret_cast<const float2*>(hc + (k + kk) * kRowsL2);
          const float hr[kRowsL2] = {hv.x, hv.y};
#pragma unroll
          for (int r = 0; r < kRowsL2; ++r) {
            acc[n][r][0] = fmaf(hr[r], w[kk].x, acc[n][r][0]);
            acc[n][r][1] = fmaf(hr[r], w[kk].y, acc[n][r][1]);
            acc[n][r][2] = fmaf(hr[r], w[kk].z, acc[n][r][2]);
            acc[n][r][3] = fmaf(hr[r], w[kk].w, acc[n][r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int r = 0; r < kRowsL2; ++r) {
        const float si = sigmoid(acc[n][r][0]);
        const float sf = sigmoid(acc[n][r][1]);
        const float so = sigmoid(acc[n][r][2]);
        const float tg = tanhf(acc[n][r][3]);
        c[n][r] = sf * c[n][r] + si * tg;
        hs[cur ^ 1][n][u][r] = so * tanhf(c[n][r]);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < kRowsL2; ++r)
      if (m0 + r < M) out[((size_t)n * M + m0 + r) * H + u] = hs[cur][n][u][r];
}

template <int N>
cudaError_t launch_l2(const float* h0, const float* c0, const float* wi,
                      float* out, int M, int T, cudaStream_t st) {
  l2_kernel<N><<<(M + kRowsL2 - 1) / kRowsL2, H, 0, st>>>(h0, c0, wi, out, M, T);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// (b) W resident across a cluster
// ---------------------------------------------------------------------------

constexpr int kCtas = 16;                   // CTAs per cluster
constexpr int kUnits = H / kCtas;           // hidden units per CTA: 20
constexpr int kCols = 4 * kUnits;           // W columns per CTA: 80
constexpr int kRowsCl = 48;                 // rows per cluster
constexpr int kRT = 8;                      // rows of a thread's tile
constexpr int kUT = 2;                      // units of a thread's tile
constexpr int kKS = 4;                      // k split over 4 adjacent lanes
constexpr int kKBlock = H / kKS;            // k of one lane: 80
constexpr int kOctets = kRowsCl / kRT;      // 6
constexpr int kTiles = kOctets * (kUnits / kUT);  // 60
constexpr int kClThreads = kTiles * kKS;    // 240
constexpr int kSkewMax = 20;  // skew(kKS - 1)
constexpr int kHWords = H * kRowsCl + kSkewMax;   // one h buffer
constexpr int kWWords = H * kCols + kSkewMax;     // the W slice
constexpr size_t kClSmem = sizeof(float) * ((size_t)kWWords + 2 * kHWords);
static_assert(H % kCtas == 0 && kUnits % kUT == 0 && H % kKS == 0 &&
              kRowsCl % kRT == 0, "the split is exact");
static_assert(kClSmem == 225520, "W slice 102,480 B + h 2 x 61,520 B");

// Returned when no cluster of this kernel fits on the device.
constexpr int kNoClusterFits = -1;

// k-block b of h and of W starts skew(b) words later, so that the four
// lanes of a tile (one k-block each) and the two tiles of a quarter-warp
// load from eight distinct 4-bank groups: the blocks start 0 mod 32
// words apart, the skews put them at groups {0, 1, 4, 5}, and the two
// tiles are 2 (or -10) groups apart.
__device__ __forceinline__ int skew(int b) { return 4 * (b & 1) + 16 * (b >> 1); }

// Word offset of row 0 of hidden unit (or k) u in an h buffer, and of k's
// row in the W slice.
__device__ __forceinline__ int h_at(int u) {
  return u * kRowsCl + skew(u / kKBlock);
}
__device__ __forceinline__ int w_at(int k) {
  return k * kCols + skew(k / kKBlock);
}

// Grid kCtas * groups * N blocks of kClThreads, clusters of kCtas along x:
// cluster (n, g) = blockIdx.x / kCtas as n * groups + g owns rows
// [48g, 48g + 48) of chain n. Dynamic shared memory kClSmem: the W slice
// (row k at w_at(k), column 4u+q for local unit u), then h, two buffers
// of kHWords (unit u's rows at h_at(u)).
//
// Lane l of warp v: k-block s = l % 4 (k = 80s .. 80s+79), tile
// g = 8v + l / 4 of rows 8(g % 6) .. +7 and local units 2(g / 6), +1. The
// four lanes of a tile reduce their partial sums by a reduce-scatter of
// shuffles, after which lane s holds the 4 gates of unit 2(g / 6) + s / 2
// for rows 8(g % 6) + 4(s % 2) .. +3: its cells, c in registers.
__global__ void __launch_bounds__(kClThreads, 1)
cluster_kernel(const float* __restrict__ h0, const float* __restrict__ c0,
               const float* __restrict__ wi, float* __restrict__ out, int M,
               int T, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* hs = smem + kWWords;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int id = blockIdx.x / kCtas;
  const int n = id / groups;
  const int m0 = (id % groups) * kRowsCl;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int s = lane % kKS;
  const int g = warp * (32 / kKS) + lane / kKS;
  const int oct = g % kOctets, pair = g / kOctets;
  const int b1 = s >> 1, b0 = s & 1;
  const int ug = rank * kUnits + kUT * pair + b1;  // the unit of this lane's cells
  const int row0 = kRT * oct + 4 * b0;             // and its first row
  const int live = kClThreads - warp * 32;         // lanes of this warp
  const unsigned mask = live >= 32 ? 0xffffffffu : (1u << live) - 1;

  // This CTA's columns of chain n's W, and the group's rows of h0 as
  // [unit][row] (rows past M are 0 and stay 0).
  const float* wn = wi + (size_t)n * H * H4 + rank * kCols;
  for (int i = tid; i < H * kCols / 4; i += kClThreads) {
    const int k = i / (kCols / 4), j = i % (kCols / 4);
    *reinterpret_cast<float4*>(ws + w_at(k) + 4 * j) =
        load4(wn + (size_t)k * H4 + 4 * j);
  }
  const float* h0n = h0 + (size_t)n * M * H;
  for (int i = tid; i < H * kRowsCl; i += kClThreads) {
    const int r = i / H, k = i % H;
    hs[h_at(k) + r] = m0 + r < M ? h0n[(size_t)(m0 + r) * H + k] : 0.0f;
  }
  float c[4], h[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + row0 + r;
    const size_t at = ((size_t)n * M + m) * H + ug;
    c[r] = m < M ? c0[at] : 0.0f;
    h[r] = m < M ? h0[at] : 0.0f;
  }
  // Every CTA of the cluster has started and filled its buffers before
  // any CTA writes into another's.
  cluster.sync();

  const float* wp = ws + w_at(kKBlock * s) + 4 * kUT * pair;
  const int hp = h_at(kKBlock * s) + kRT * oct;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* hc = hs + cur * kHWords + hp;
    float acc[kUT][kRT][4];
#pragma unroll
    for (int u = 0; u < kUT; ++u)
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][r][q] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kKBlock; ++j) {
      const float4 ha = *reinterpret_cast<const float4*>(hc + j * kRowsCl);
      const float4 hb = *reinterpret_cast<const float4*>(hc + j * kRowsCl + 4);
      const float4 wa = *reinterpret_cast<const float4*>(wp + j * kCols);
      const float4 wb = *reinterpret_cast<const float4*>(wp + j * kCols + 4);
      const float hr[kRT] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      const float4 wu[kUT] = {wa, wb};
#pragma unroll
      for (int u = 0; u < kUT; ++u) {
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          acc[u][r][0] = fmaf(hr[r], wu[u].x, acc[u][r][0]);
          acc[u][r][1] = fmaf(hr[r], wu[u].y, acc[u][r][1]);
          acc[u][r][2] = fmaf(hr[r], wu[u].z, acc[u][r][2]);
          acc[u][r][3] = fmaf(hr[r], wu[u].w, acc[u][r][3]);
        }
      }
    }
    // Reduce-scatter over the tile's four lanes: lane s keeps unit s / 2
    // (xor 2), then rows 4(s % 2) .. +3 of it (xor 1).
    float unit[kRT * 4];
#pragma unroll
    for (int i = 0; i < kRT * 4; ++i) {
      const float a0 = acc[0][i / 4][i % 4], a1 = acc[1][i / 4][i % 4];
      unit[i] = (b1 ? a1 : a0) + __shfl_xor_sync(mask, b1 ? a0 : a1, 2);
    }
    float gates[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float lo = unit[i], hi = unit[16 + i];
      gates[i] = (b0 ? hi : lo) + __shfl_xor_sync(mask, b0 ? lo : hi, 1);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float si = sigmoid(gates[4 * r]);
      const float sf = sigmoid(gates[4 * r + 1]);
      const float so = sigmoid(gates[4 * r + 2]);
      const float tg = tanhf(gates[4 * r + 3]);
      c[r] = sf * c[r] + si * tg;
      h[r] = so * tanhf(c[r]);
    }
    // Publish this lane's 4 rows of unit ug to every CTA's next buffer.
    const float4 hv = make_float4(h[0], h[1], h[2], h[3]);
    float* dst = hs + (cur ^ 1) * kHWords + h_at(ug) + row0;
#pragma unroll
    for (int r = 0; r < kCtas; ++r)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, r)) = hv;
    cluster.sync();
    cur ^= 1;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + row0 + r;
    if (m < M) out[((size_t)n * M + m) * H + ug] = h[r];
  }
}

// The launch configuration of cluster_kernel for a grid of `blocks`.
cudaError_t cluster_config(int blocks, cudaStream_t st, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kClSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(cluster_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kClThreads);
  cfg->dynamicSmemBytes = kClSmem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t max_clusters(int blocks, cudaStream_t st, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(blocks, st, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)cluster_kernel, &cfg);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers:
// h0, c0 and out [N,M,320] f32, wi [N,320,1280] f32 gate-interleaved (see
// the header). Each returns cudaGetLastError() after its launch (0 on
// success).

// (a): N in 1..4.
extern "C" int pipeline_probe_l2(const float* h0, const float* c0,
                                 const float* wi, float* out, int N, int M,
                                 int T, void* stream) {
  if (N < 1 || N > kMaxChains || M < 1 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return (int)launch_l2<1>(h0, c0, wi, out, M, T, st);
    case 2: return (int)launch_l2<2>(h0, c0, wi, out, M, T, st);
    case 3: return (int)launch_l2<3>(h0, c0, wi, out, M, T, st);
    default: return (int)launch_l2<4>(h0, c0, wi, out, M, T, st);
  }
}

// (b): any N. Returns kNoClusterFits (-1) without launching when
// cudaOccupancyMaxActiveClusters finds no place for one cluster.
extern "C" int pipeline_probe_cluster(const float* h0, const float* c0,
                                      const float* wi, float* out, int N,
                                      int M, int T, void* stream) {
  if (N < 1 || M < 1 || T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (M + kRowsCl - 1) / kRowsCl;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kCtas * groups * N, st, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void*)cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kNoClusterFits;
  e = cudaLaunchKernelEx(&cfg, cluster_kernel, h0, c0, wi, out, M, T, groups);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of (b) the device holds at once (written to
// *clusters); returns the CUDA error of the query.
extern "C" int pipeline_probe_max_clusters(int* clusters, void* stream) {
  *clusters = 0;
  return (int)max_clusters(kCtas, static_cast<cudaStream_t>(stream), clusters);
}

extern "C" const char* pipeline_probe_error_string(int code) {
  if (code == kNoClusterFits) {
    return "no cluster of 16 CTAs with 225,280 B of shared memory each fits "
           "on this device (cudaOccupancyMaxActiveClusters returned 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
