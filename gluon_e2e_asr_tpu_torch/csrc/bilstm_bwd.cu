// K1-bwd: the backward of one bidirectional LSTM layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel gluon_e2e_asr_tpu/ops/pallas_lstm.py::bilstm_fused
// (VJP: _v2_vjp_bwd -> pl.pallas_call -> _v2_bwd_kernel). Same math, in the
// caller's gate order (i,f,g,o) and layouts:
//
//   per direction, sweeping its time order backwards (the forward
//   direction t = T-1 .. 0, the backward direction t = 0 .. T-1), with
//   c_prev the c stream at t-1 (forward) or t+1 (backward), 0 outside
//   [0, T) and, since the streams are 0 past lens, 0 at a backward row's
//   last valid frame:
//     dh = dy_t (0 at t >= lens[b]) + dh_rec
//     do = dh * tanh(c_t)
//     dc = dh * so * (1 - tanh(c_t)^2) + dc_carry
//     dg = (dc*tg*si*(1-si), dc*c_prev*sf*(1-sf), dc*si*(1-tg^2), do*so*(1-so))
//     dh_rec = dg(cd) . W_h^T(cd)        f32 accumulation
//     dc_carry = dc * sf
//   dx   = dg(cd) . W_x^T(cd)            over both directions' 8H columns
//   dW_x = x^T(cd) . dg(cd)
//   dW_h = h_prev^T(cd) . dg(cd)         h_prev from the stored h stream
//   db   = sum of dg over (b, t), in f32
//
// The gate activations are not recomputed: K1-fwd's training form
// (bilstm_fwd.cu) leaves them in its xg buffer, masked to 0 past lens, so
// every dg term vanishes at an invalid step and the carries stay 0 until
// a direction's sweep reaches its first valid frame, as in the TPU kernel.
//
// Kernels on the caller's stream, no allocation, no synchronisation:
//
//   (a) the reverse recurrence, which writes dg [B,T,8H] f32. Chosen by
//       shape alone: bwd_cluster_kernel for H <= 320 (every config of the
//       repo: 320 and 256), bwd_recur_kernel for 320 < H <= 1024. A launch
//       failure of either raises in the wrapper; nothing falls back.
//   (b) the products dx, dW_x and dW_h (bilstm_bwd_products): in bf16
//       on wgmma, gemm_sm90.cuh's dx_kernel and wgrad_kernel (its header
//       has the design); in f32 through gemm.cuh's gemm_f32_kernel on the
//       FMA units (true f32). The weight gradients split their long depth
//       (B*T) over blocks and add atomically.
//   (c) db: summed by wgrad_kernel's producers in bf16, by colsum_kernel
//       in f32.
//   (d) K7-bwd (bilstm_v1_bwd) with bf16 projections and an f32 compute
//       dtype only: bilstm_v1_gates first recomputes the gate activations
//       from the rounded h stream, as the TPU backward kernel does (one
//       f32 product of gemm.cuh a direction over all frames, the
//       activations in its epilogue); the forward's, from the unrounded
//       h, are not those.
//
// bwd_cluster_kernel: W_h resident across a cluster of 16 CTAs.
//   One cluster of kCtas = 16 CTAs per (direction, group of R batch
//   rows). CTA r owns hidden units [rU, rU + U), U = 4 * ceil(H / 64)
//   (20 at H=320, 16 at H=256; a multiple of 4 so that a 16-byte store
//   of 4 units never straddles two owners); units past H compute
//   nothing. It owns the 4U dg columns of its units, local column
//   j = 4*lu + g for gate g of local unit lu, and holds W_h's weights of
//   those columns for all T steps, in shared memory in the compute dtype:
//   the slice [j][u'] = W_h[u'][g*H + rU + lu] for u' in [0, 16U), zero
//   past H (102,400 B in f32, 51,200 B in bf16 at H=320). The wrapper
//   ships the 16 slices as one [16][4U][16U] tensor (ops/bilstm.py::
//   _cluster_slices); the slice is the columns [4rU, 4rU + 4U) of K1-fwd's
//   gate-interleaved W_h, transposed and padded. Each step has three
//   phases:
//   (1) elementwise: thread i < R*U/4 owns row i / (U/4) and local units
//       4(i % (U/4)) .. +3 of its CTA (a warp's lanes run along the units
//       of a row, so that its loads and stores of the streams and of dg
//       are 16-byte vectors of few rows). It sums dh_rec of its 4 cells
//       from the 16 slots of the receive buffer in slot order 0..15 (a
//       fixed order), forms dh, do, dc, the four dg terms and the dc carry
//       as bwd_recur_kernel does (the carry reset at invalid steps, c_prev
//       0 outside [0, T)), and writes dg, rounded to the compute dtype, as
//       f32 into shared memory as [j][R] (in the receive buffer it has
//       just read; each group of 16 columns 4 words further, against bank
//       conflicts: dg_at). Then it loads the next step's acts, c at t and
//       at t_prev and dy of its cells into registers, so that their
//       latency hides behind the product.
//   (2) product: thread i < R*U/4 owns a tile of 16 rows (16 * (i / 4U))
//       and 4 units (4 * (i % 4U)) of dh_rec's partial over this CTA's
//       columns, P[row][u'] = sum_j dg[row][j] * W[j][u'], depth 4U, f32
//       FMAs (no TF32): per j four float4 of dg (broadcast: the lanes of
//       a warp share their rows) and one 16-byte (f32) or 8-byte (bf16)
//       load of W (a warp's lanes read consecutive vectors), 64 FMAs for 5
//       loads. The 4 units of a tile belong to one owner, because U is a
//       multiple of 4. The W slice needs no skew: a warp's lanes read 32
//       consecutive vectors of one row j.
//   (3) reduce-scatter: the thread stores its 16 rows x 4 units into slot
//       r (its CTA's rank) of the owner's receive buffer through
//       cluster.map_shared_rank, one 16-byte store a row; one cluster
//       barrier ends the step, split into its arrival and its wait, with
//       the step's dg stores to device memory (f32) between them. The
//       receive buffers are double-buffered, [2][16 slots][R][U] f32, so
//       one cluster barrier a step is enough: a buffer is written in step
//       s + 1 only after every CTA has passed the barrier of step s, by
//       which time its owner has summed it and run the product that reads
//       dg from it. Two CTA barriers guard the reuse of the buffer for dg
//       inside a step.
//   Rows per cluster R: the fewest of 16, 32 and 48 for which the
//   2 * ceil(B / R) clusters (2 directions) fit on the card at once
//   (cudaOccupancyMaxActiveClusters, asked once per R and U), else 48 and
//   the clusters run in waves: on the H100 B=96 takes 32 (6 clusters of
//   at most 7), B=50 32, B=16 16. A step's work is about proportional to
//   R, so fewer rows a cluster and more clusters are faster while they
//   fit in one wave. Shared memory 4U*16U*sizeof(W) + 2*16*R*U*4 B:
//   225,280 B at H=320, R=48, f32 (184,320 at R=32), within the 232,448
//   a block may have for every H <= 320 and R <= 48. When not even one
//   cluster fits, the launch returns kNoClusterFits.
//   One step at the flagship's layer shape (H=320, B=96, R=32: 6
//   clusters, 96 CTAs, one wave): 819,200 FMAs a CTA (32 x 320 x 80),
//   40,960 B stored through distributed shared memory a CTA (38,400 of
//   them to other CTAs), one cluster barrier and two CTA barriers; from
//   device memory 17,920 B of streams in and 10,240 B of dg out a CTA.
//   What bounds it: shared memory in the product, 5 loads per 64 FMAs, at
//   about 5 cycles per 16-byte load a warp on the H100 (as in
//   pipeline_probe.cu's cluster kernel); the product takes about 6.5 of
//   a step's 11 us there, and the elementwise phase, the exchange and the
//   barrier, each small when cut alone, the rest (PERF.md, measured with
//   tools/k1b_probe.py --ablate).
//
// bwd_recur_kernel (320 < H <= 1024): one persistent block per (direction,
//   group of kRows batch rows) loops over time; thread u owns hidden unit
//   u and its four gate derivatives for the block's rows. It writes dg to
//   device memory (f32) and, rounded to the compute dtype, to shared
//   memory (double buffered, one barrier a step), from which it forms its
//   own entry of dh_rec = dg . W_h^T. The caller passes W_h in the layout
//   wt[(q*H + u)*4 + e] = W_h[u][4q + e]: the four weights of unit u that
//   meet dg columns 4q..4q+3 are one vector load, and neighbouring threads
//   load neighbouring vectors (coalesced). Every step every block reads
//   all of W_h from L2 and does kRows*4H*H FMAs, and a step cannot start
//   before the previous one ended.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace cg = cooperative_groups;

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
using port::lds4;
using port::load4;
using port::round_bf16;

// 1: the bf16 products on wgmma (gemm_sm90.cuh). 0 builds gemm.cuh's WMMA
// kernel (gemm_bf16_kernel) in their place: a build variant that
// tools/k1b_probe.py --products times beside them, on no model path (the
// main build does not compile that kernel).
#define K1B_WGMMA_PRODUCTS 1

constexpr int kRows = 2;  // batch rows per recurrence block
constexpr int kUnroll = 16;

// Grid (ceil(B/kRows), 2): blockIdx.y is the direction. blockDim.x >= H.
// Dynamic shared memory: dg as [2 buffers][4H][kRows] f32.
template <typename WT>
__global__ void bwd_recur_kernel(const float* __restrict__ dy,
                                 const int* __restrict__ lens,
                                 const float* __restrict__ acts,
                                 const float* __restrict__ cs,
                                 const WT* __restrict__ wtf,
                                 const WT* __restrict__ wtb,
                                 float* __restrict__ dg, int B, int T, int H,
                                 int cd_bf16) {
  extern __shared__ __align__(16) float gs[];
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int u = threadIdx.x;
  const bool active = u < H;
  const WT* __restrict__ wt = dir ? wtb : wtf;
  const int H4 = 4 * H;
  const size_t g_row = (size_t)8 * H;  // acts and dg: [B,T,8H]
  const size_t s_row = (size_t)2 * H;  // dy and cs: [B,T,2H]

  int len[kRows];
  float dh_rec[kRows], dcc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    len[r] = (b0 + r < B) ? lens[b0 + r] : 0;
    dh_rec[r] = 0.0f;
    dcc[r] = 0.0f;
  }

  int cur = 0;
  for (int s = 0; s < T; ++s) {
    const int t = dir ? s : T - 1 - s;
    const int tp = dir ? t + 1 : t - 1;  // where the "previous" state lives
    float* gn = gs + cur * H4 * kRows;
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        float g4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (t < len[r]) {
          const float* a = acts + (size_t)(b * T + t) * g_row + dir * H4;
          const float si = a[u], sf = a[H + u], tg = a[2 * H + u], so = a[3 * H + u];
          const size_t at = (size_t)(b * T + t) * s_row + dir * H + u;
          const float th = tanhf(cs[at]);
          const float cp = (tp >= 0 && tp < T)
              ? cs[(size_t)(b * T + tp) * s_row + dir * H + u] : 0.0f;
          const float dh = dy[at] + dh_rec[r];
          const float d_o = dh * th;
          const float dc = dh * so * (1.0f - th * th) + dcc[r];
          g4[0] = dc * tg * si * (1.0f - si);
          g4[1] = dc * cp * sf * (1.0f - sf);
          g4[2] = dc * si * (1.0f - tg * tg);
          g4[3] = d_o * so * (1.0f - so);
          dcc[r] = dc * sf;
        } else {
          dcc[r] = 0.0f;
        }
        if (b < B) {
          float* o = dg + (size_t)(b * T + t) * g_row + dir * H4;
#pragma unroll
          for (int g = 0; g < 4; ++g) o[g * H + u] = g4[g];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gn[(g * H + u) * kRows + r] = cd_bf16 ? round_bf16(g4[g]) : g4[g];
      }
    }
    __syncthreads();
    if (active) {
      // dh_rec[u] = sum_j dg[j] * W_h[u][j], four columns j a load.
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const WT* __restrict__ wu = wt + (size_t)4 * u;
      int q = 0;
      for (; q + kUnroll <= H; q += kUnroll) {
        float4 w[kUnroll];
#pragma unroll
        for (int qq = 0; qq < kUnroll; ++qq)
          w[qq] = load4(wu + (size_t)(q + qq) * H4);
#pragma unroll
        for (int qq = 0; qq < kUnroll; ++qq) {
          const float* g = gn + 4 * (q + qq) * kRows;
          const float wv[4] = {w[qq].x, w[qq].y, w[qq].z, w[qq].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gv = *reinterpret_cast<const float2*>(g + e * kRows);
            acc[0] = fmaf(gv.x, wv[e], acc[0]);
            acc[1] = fmaf(gv.y, wv[e], acc[1]);
          }
        }
      }
      for (; q < H; ++q) {
        const float4 w = load4(wu + (size_t)q * H4);
        const float* g = gn + 4 * q * kRows;
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gv = *reinterpret_cast<const float2*>(g + e * kRows);
          acc[0] = fmaf(gv.x, wv[e], acc[0]);
          acc[1] = fmaf(gv.y, wv[e], acc[1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh_rec[r] = acc[r];
    }
    cur ^= 1;
  }
  static_assert(kRows == 2, "dg rows are read as one float2");
}

template <typename WT>
cudaError_t launch_bwd_recur(const float* dy, const int* lens,
                             const float* acts, const float* cs,
                             const void* wtf, const void* wtb, float* dg,
                             int B, int T, int H, int cd_bf16,
                             cudaStream_t st) {
  // 20 KB at H=320; up to 64 KB at H=1024, above the 48 KB default.
  const size_t smem = sizeof(float) * 2 * (size_t)4 * H * kRows;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_recur_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const int threads = ((H + 31) / 32) * 32;
  bwd_recur_kernel<WT><<<grid, threads, smem, st>>>(
      dy, lens, acts, cs, static_cast<const WT*>(wtf),
      static_cast<const WT*>(wtb), dg, B, T, H, cd_bf16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bwd_cluster_kernel: W_h resident across a cluster (see the header)
// ---------------------------------------------------------------------------

// kCtas, kClusterMaxHidden, kMaxRows, kNoClusterFits, cluster_units,
// cluster_rows, cluster_config, cluster_capacity and the split cluster
// barrier: common.cuh.
constexpr int kTileRows = 16;           // rows of a product tile
constexpr int kClThreadsMax = 256;      // kMaxRows * 20 / 4 = 240, in warps

// Four adjacent floats of a stream, for units u0 .. u0+3 (0 past H): one
// 16-byte load when `vec` (H % 4 == 0, so u0 is 16-byte aligned), else
// four loads.
__device__ __forceinline__ float4 stream4(const float* p, int u0, int H,
                                          bool vec) {
  if (vec) {
    return u0 < H ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = u0 + c < H ? __ldg(p + c) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void split4(float4 v, float* d) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Where dg column j starts in the [j][R] f32 dg buffer: rows contiguous,
// and each group of 16 columns (one thread's four units) 4 words further,
// so that the lanes of a warp, which write one column for 4-5 units of
// each of 6-8 rows, spread over more banks. A multiple of 4: the product
// reads 16-byte vectors.
__device__ __forceinline__ int dg_at(int j, int R) {
  return j * R + 4 * ((j >> 4) & 7);
}

// dg as the product's operand: f32, rounded to bf16 where W is bf16. (A
// bf16 operand takes two 16-byte loads a j instead of four but 16 more
// instructions to widen; it measured no faster on the H100: PERF.md.)
__device__ __forceinline__ float operand(const float*, float v) { return v; }
__device__ __forceinline__ float operand(const __nv_bfloat16*, float v) {
  return round_bf16(v);
}

// Grid kCtas * groups * 2 blocks, clusters of kCtas along x: cluster
// id = blockIdx.x / kCtas is direction id / groups, rows
// [R * (id % groups), +R). ws: the [kCtas][4U][16U] slices of W_h
// (_cluster_slices) of the forward (wsf) and backward (wsb) direction.
// Dynamic shared memory: this CTA's slice [4U][16U] of WT, then the
// receive buffers [2][kCtas][R][U] f32.
template <typename WT>
__global__ void __launch_bounds__(kClThreadsMax, 1)
bwd_cluster_kernel(const float* __restrict__ dy, const int* __restrict__ lens,
                   const float* __restrict__ acts, const float* __restrict__ cs,
                   const WT* __restrict__ wsf, const WT* __restrict__ wsb,
                   float* __restrict__ dg, int B, int T, int H, int R,
                   int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int id = blockIdx.x / kCtas;
  const int dir = id / groups;
  const int b0 = (id % groups) * R;
  const int U = cluster_units(H);
  const int Hp = kCtas * U;      // padded units
  const int J = 4 * U;           // this CTA's dg columns
  const int active = R * U / 4;  // threads with cells and a tile
  const int slot = R * U;        // floats of one sender's slot
  const int buf = kCtas * slot;  // floats of one receive buffer
  const int H4 = 4 * H;
  const size_t g_row = (size_t)8 * H;  // acts and dg: [B,T,8H]
  const size_t s_row = (size_t)2 * H;  // dy and cs: [B,T,2H]
  const int tid = threadIdx.x;
  WT* ws = reinterpret_cast<WT*>(smem);
  float* recv = reinterpret_cast<float*>(smem + sizeof(WT) * (size_t)J * Hp);

  // This CTA's slice of W_h, 16 bytes a load.
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        (dir ? wsb : wsf) + (size_t)rank * J * Hp);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    const int n = (int)(sizeof(WT) * (size_t)J * Hp / 16);
    for (int i = tid; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }

  // The cells of phase (1): row `row`, local units lq .. lq+3 (the lanes
  // of a warp run along the units of a row, then along the rows).
  const bool on = tid < active;
  const int row = tid / (U / 4);
  const int lq = 4 * (tid % (U / 4));
  const int b = b0 + row;
  const int u0 = rank * U + lq;
  const int len = (on && b < B) ? lens[b] : 0;
  const bool vec = H % 4 == 0;  // then u0..u0+3 is one 16-byte vector
  // The tile of phase (2): rows 16*rg .. +15, units 4*quad .. +3, whose
  // owner is CTA quad / (U/4), at its local unit 4 * (quad % (U/4)).
  const int rg = tid / J, quad = tid % J;
  const int owner = quad / (U / 4);
  const int lo = 4 * (quad % (U / 4));

  // The streams of one step for this thread's cells, prefetched:
  // [gate or stream][cell].
  float pa[4][4], pc[4], pp[4], pd[4];
  auto fetch = [&](int s) {
    const int t = dir ? s : T - 1 - s;
    const int tp = dir ? t + 1 : t - 1;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 va[4] = {z, z, z, z}, vc = z, vd = z, vp = z;
    if (t < len) {
      const float* a = acts + (size_t)(b * T + t) * g_row + dir * H4 + u0;
#pragma unroll
      for (int g = 0; g < 4; ++g) va[g] = stream4(a + g * H, u0, H, vec);
      const size_t at = (size_t)(b * T + t) * s_row + dir * H + u0;
      vc = stream4(cs + at, u0, H, vec);
      vd = stream4(dy + at, u0, H, vec);
      if (tp >= 0 && tp < T)
        vp = stream4(cs + (size_t)(b * T + tp) * s_row + dir * H + u0, u0, H,
                     vec);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) split4(va[g], pa[g]);
    split4(vc, pc);
    split4(vd, pd);
    split4(vp, pp);
  };

  float dcc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float g4[4][4];  // this step's dg of the cells: [gate][cell]
  // dg of the cells to device memory, in f32.
  auto store_dg = [&](int t) {
    if (!on || b >= B || u0 >= H) return;
    float* o = dg + (size_t)(b * T + t) * g_row + dir * H4 + u0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (vec) {
        *reinterpret_cast<float4*>(o + g * H) =
            make_float4(g4[g][0], g4[g][1], g4[g][2], g4[g][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (u0 + c < H) o[g * H + c] = g4[g][c];
      }
    }
  };
  fetch(0);
  // Every CTA of the cluster has started and holds its slice before any
  // CTA stores into another's receive buffer.
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int t = dir ? s : T - 1 - s;
    const int cur = s & 1;
    float* prev = recv + (cur ^ 1) * buf;  // written in step s-1
    // (1) elementwise
    if (on) {
      float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (s > 0) {
        const float* p = prev + row * U + lq;
#pragma unroll
        for (int k = 0; k < kCtas; ++k) {  // slot order: a fixed order
          const float4 v = *reinterpret_cast<const float4*>(p + k * slot);
          dh[0] += v.x;
          dh[1] += v.y;
          dh[2] += v.z;
          dh[3] += v.w;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t < len && u0 + c < H) {
          const float si = pa[0][c], sf = pa[1][c], tg = pa[2][c], so = pa[3][c];
          const float th = tanhf(pc[c]);
          const float d = pd[c] + dh[c];
          const float d_o = d * th;
          const float dc = d * so * (1.0f - th * th) + dcc[c];
          g4[0][c] = dc * tg * si * (1.0f - si);
          g4[1][c] = dc * pp[c] * sf * (1.0f - sf);
          g4[2][c] = dc * si * (1.0f - tg * tg);
          g4[3][c] = d_o * so * (1.0f - so);
          dcc[c] = dc * sf;
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) g4[g][c] = 0.0f;
          dcc[c] = 0.0f;
        }
      }
    }
    if (s == T - 1) {  // the last step's dh_rec is not needed
      store_dg(t);
      break;
    }
    __syncthreads();  // every read of `prev` is done: it now takes dg
    float* dgs = prev;  // [j][R]
    if (on) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dgs[dg_at(4 * (lq + c) + g, R) + row] = operand(ws, g4[g][c]);
      fetch(s + 1);
    }
    __syncthreads();
    // (2) product and (3) reduce-scatter
    if (on) {
      float acc[kTileRows][4];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      const float* dp = dgs + kTileRows * rg;
      const WT* wp = ws + 4 * quad;
#pragma unroll 4
      for (int j = 0; j < J; ++j) {
        const float* dj = dp + dg_at(j, R);
        float dr[kTileRows];
#pragma unroll
        for (int i = 0; i < kTileRows; i += 4)
          split4(*reinterpret_cast<const float4*>(dj + i), dr + i);
        const float4 w = lds4(wp + (size_t)j * Hp);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          acc[i][0] = fmaf(dr[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(dr[i], w.y, acc[i][1]);
          acc[i][2] = fmaf(dr[i], w.z, acc[i][2]);
          acc[i][3] = fmaf(dr[i], w.w, acc[i][3]);
        }
      }
      float* dst = recv + cur * buf + rank * slot + kTileRows * rg * U + lo;
      dst = cluster.map_shared_rank(dst, owner);
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        *reinterpret_cast<float4*>(dst + i * U) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    cluster_arrive();
    store_dg(t);  // while the cluster gathers at the barrier
    cluster_wait();
  }
}

template <typename WT>
size_t cluster_smem(int R, int U) {
  return sizeof(WT) * (size_t)4 * U * kCtas * U
      + sizeof(float) * 2 * (size_t)kCtas * R * U;
}

// Clusters of bwd_cluster_kernel<WT> with R rows at U units the device
// holds at once, asked once per (R, U) and process.
template <typename WT>
cudaError_t bwd_capacity(int R, int U, cudaStream_t st, int* clusters) {
  static int known[kMaxRows / kRowStep][kClusterMaxHidden / 16 / 4 + 1] = {};
  return port::cluster_capacity(bwd_cluster_kernel<WT>, cluster_smem<WT>(R, U),
                                R * U / 4, st, known[R / kRowStep - 1][U / 4],
                                clusters);
}

template <typename WT>
int launch_bwd_cluster(const float* dy, const int* lens, const float* acts,
                       const float* cs, const void* wsf, const void* wsb,
                       float* dg, int B, int T, int H, cudaStream_t st) {
  const int U = cluster_units(H);
  int R = 0, capacity = 0;
  cudaError_t e = cluster_rows(
      B, [&](int r, int* n) { return bwd_capacity<WT>(r, U, st, n); },
      &R, &capacity);
  if (e != cudaSuccess) return (int)e;
  if (capacity < 1) return kNoClusterFits;
  const int groups = (B + R - 1) / R;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = port::cluster_config(bwd_cluster_kernel<WT>, cluster_smem<WT>(R, U),
                           R * U / 4, groups, st, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, bwd_cluster_kernel<WT>, dy, lens, acts, cs,
                         static_cast<const WT*>(wsf),
                         static_cast<const WT*>(wsb), dg, B, T, H, R, groups);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The reverse recurrence, chosen by shape alone: the cluster kernel for
// H <= kClusterMaxHidden (wtf/wtb the _cluster_slices layout), else
// bwd_recur_kernel (wtf/wtb the _transpose_quads layout).
int launch_recurrence(const float* dy, const int* lens, const float* acts,
                      const float* cs, const void* wtf, const void* wtb,
                      float* dg, int B, int T, int H, int cd_bf16,
                      cudaStream_t st) {
  if (H <= kClusterMaxHidden) {
    return cd_bf16
        ? launch_bwd_cluster<__nv_bfloat16>(dy, lens, acts, cs, wtf, wtb, dg,
                                            B, T, H, st)
        : launch_bwd_cluster<float>(dy, lens, acts, cs, wtf, wtb, dg, B, T,
                                    H, st);
  }
  return (int)(cd_bf16
      ? launch_bwd_recur<__nv_bfloat16>(dy, lens, acts, cs, wtf, wtb, dg, B,
                                        T, H, 1, st)
      : launch_bwd_recur<float>(dy, lens, acts, cs, wtf, wtb, dg, B, T, H, 0,
                                st));
}

// h_prev of one direction as the A operand of dW_h = h_prev^T . dg:
// (u, row) with row = b*T + t reads the direction's h stream (y, rows of
// ld floats, at its first column) at t-1 (forward direction) or t+1
// (backward direction), 0 outside [0, T).
struct HPrevT {
  const float* y;
  int T, H, M, dir, ld;
  bool vec;  // gemm::vec_ok(y, ld)
  static constexpr bool kFirstContig = true;
  // The row of y that holds h_prev for `row`, or -1 where it is 0.
  __device__ __forceinline__ int src(int row) const {
    if (row >= M) return -1;
    const int t = row % T;
    const int tp = dir ? t + 1 : t - 1;
    return (tp < 0 || tp >= T) ? -1 : row - t + tp;
  }
  __device__ __forceinline__ float operator()(int u, int row) const {
    const int r = src(row);
    return (r < 0 || u >= H) ? 0.0f : y[(size_t)r * ld + u];
  }
  __device__ __forceinline__ float4 four(int u, int row) const {
    const int r = src(row);
    if (vec && r >= 0 && u + 3 < H)
      return *reinterpret_cast<const float4*>(y + (size_t)r * ld + u);
    return make_float4((*this)(u, row), (*this)(u + 1, row),
                       (*this)(u + 2, row), (*this)(u + 3, row));
  }
};

// K7-bwd's gates recomputed for bf16 projections with an f32 compute
// dtype (gate_acts). h_prev of one direction as the A operand of the gate
// product h_prev . W_h: (row, u) with row = b*T + t reads the direction's
// h stream (y, rows of ld floats, at its first column) at t-1 (forward
// direction) or t+1 (backward direction), 0 outside [0, T): HPrevT's
// operand, not transposed.
struct HPrev {
  HPrevT h;
  static constexpr bool kFirstContig = false;
  __device__ __forceinline__ float operator()(int row, int u) const {
    return h(u, row);
  }
  __device__ __forceinline__ float4 four(int row, int u) const {
    return make_float4(h(u, row), h(u + 1, row), h(u + 2, row),
                       h(u + 3, row));
  }
};

// The gate product's epilogue: (row, n) of one direction's pre-activation
// xg + h_prev . W_h, as the TPU backward kernel forms it
// (_cell_math: xg in f32 plus the product), its activation (sigmoid,
// sigmoid of +1 for the forget gate, tanh, sigmoid: gate n / H) into the
// direction's columns of acts [B*T, 8H], 0 at t >= lens[b], as K1-fwd's
// training form leaves them.
struct GateActs {
  const __nv_bfloat16* xg;  // [B*T, 4H], this direction's projections
  const int* lens;
  float* acts;
  int T, H, dir;
  __device__ __forceinline__ void operator()(int row, int n, float v) const {
    const int t = row % T;
    float a = 0.0f;
    if (t < lens[row / T]) {
      const float g = __bfloat162float(xg[(size_t)row * 4 * H + n]) + v;
      const int q = n / H;
      a = q == 2 ? tanhf(g) : port::sigmoid(q == 1 ? g + 1.0f : g);
    }
    acts[(size_t)row * 8 * H + dir * 4 * H + n] = a;
  }
};

// db[n] += sum over a block's rows of dg[row][n].
__global__ void colsum_kernel(const float* __restrict__ dg,
                              float* __restrict__ db, int M, int N,
                              int rows_per_block) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += dg[(size_t)r * N + n];
  atomicAdd(db + n, s);
}

// dx (with x), dW_x (with x) and dW_h through gemm.cuh's tiled kernels:
// the f32 route, and the WMMA build variant.
template <bool kBf16>
cudaError_t tiled_products(const float* x, int ldx, const float* wx,
                           const float* y, int ldy, int yb, const float* dg,
                           float* dx, float* dwx, float* dwhf, float* dwhb,
                           int B, int T, int D, int H, cudaStream_t st) {
  const int M = B * T;
  const int N8 = 8 * H, N4 = 4 * H;
  cudaError_t e;
  const gemm::RowMajor dg_all{dg, N8, M, N8, gemm::vec_ok(dg, N8)};
  if (x != nullptr) {
    // dx [M, D] = dg [M, 8H] . W_x^T
    e = gemm::launch<kBf16>(
        dg_all, gemm::Transposed{wx, N8, N8, D, gemm::vec_ok(wx, N8)},
        gemm::Store{dx, D}, M, D, N8, 1, st);
    if (e != cudaSuccess) return e;
    // dW_x [D, 8H] = x^T . dg
    e = gemm::launch<kBf16>(
        gemm::Transposed{x, ldx, D, M, gemm::vec_ok(x, ldx)}, dg_all,
        gemm::AtomicAdd{dwx, N8}, D, N8, M, gemm::split_k(D, N8, M), st);
    if (e != cudaSuccess) return e;
  }
  // dW_h [H, 4H] = h_prev^T . dg, per direction
  for (int dir = 0; dir < 2; ++dir) {
    const float* dgd = dg + dir * N4;
    const float* yd = y + (dir ? yb : 0);
    e = gemm::launch<kBf16>(
        HPrevT{yd, T, H, M, dir, ldy, gemm::vec_ok(yd, ldy)},
        gemm::RowMajor{dgd, N8, M, N4, gemm::vec_ok(dgd, N8)},
        gemm::AtomicAdd{dir ? dwhb : dwhf, N4}, H, N4, M,
        gemm::split_k(H, N4, M), st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The products of one layer's backward from dg [B,T,8H]: with x (K1-bwd)
// dx, dW_x and db, and always dW_h of both directions (K7-bwd passes no
// x). x has rows of ldx floats; y rows of ldy floats, the forward
// direction's h at column 0 and the backward direction's at column yb.
// bf16 on wgmma (gemm_sm90.cuh; dx from wx16, W_x's bf16 copy, and db
// summed by the weight gradients' kernel), f32 on the FMA units
// (gemm.cuh; db by colsum_kernel).
int launch_products(const float* x, int ldx, const int* lens, const float* wx,
                    const __nv_bfloat16* wx16, const float* y, int ldy, int yb,
                    const float* dg, float* dx, float* dwx, float* db,
                    float* dwhf, float* dwhb, int B, int T, int D, int H,
                    bool bf16, cudaStream_t st) {
  const int M = B * T;
  const int N8 = 8 * H, N4 = 4 * H;
  cudaError_t e;
  const size_t f = sizeof(float);
  if (x != nullptr) {
    if ((e = cudaMemsetAsync(dwx, 0, f * D * N8, st)) != cudaSuccess) return (int)e;
    if ((e = cudaMemsetAsync(db, 0, f * N8, st)) != cudaSuccess) return (int)e;
  }
  if ((e = cudaMemsetAsync(dwhf, 0, f * H * N4, st)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(dwhb, 0, f * H * N4, st)) != cudaSuccess) return (int)e;

  if (bf16) {
#if K1B_WGMMA_PRODUCTS
    int rc = 0;
    if (x != nullptr &&
        (rc = gemm_sm90::launch_dx(dg, wx16, lens, dx, B, T, D, H, st)) != 0) {
      return rc;
    }
    return gemm_sm90::launch_wgrad(x, ldx, D, y, ldy, yb, dg, lens, dwx, db,
                                   dwhf, dwhb, B, T, H, st);
#else
    e = tiled_products<true>(x, ldx, wx, y, ldy, yb, dg, dx, dwx, dwhf, dwhb,
                             B, T, D, H, st);
#endif
  } else {
    e = tiled_products<false>(x, ldx, wx, y, ldy, yb, dg, dx, dwx, dwhf, dwhb,
                              B, T, D, H, st);
  }
  if (e != cudaSuccess) return (int)e;
  if (x != nullptr) {
    constexpr int kColThreads = 256, kColRows = 512;
    const dim3 cgrid((N8 + kColThreads - 1) / kColThreads,
                     (M + kColRows - 1) / kColRows);
    colsum_kernel<<<cgrid, kColThreads, 0, st>>>(dg, db, M, N8, kColRows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.

// K1-bwd's products (the reverse recurrence's bilstm_bwd_recur comes
// first): x [B,T,D] with rows of ldx floats (ldx >= D), wx [D,8H] and,
// for bf16, wx16, its bf16 copy (the wgmma route reads W_x that way), y
// [B,T,*] with rows of ldy floats holding K1-fwd's h stream, the forward
// direction's at columns 0 .. H and the backward direction's at yb .. yb
// + H (yb = H when y is [B,T,2H]; ldx, ldy and yb multiples of 4 for
// bf16), dg [B,T,8H] as the recurrence writes it (0 at t >= lens[b],
// which the bf16 products rely on), all f32. Outputs,
// f32: dx [B,T,D], dwx [D,8H], db [8H], dwhf and dwhb [H,4H]. Returns
// cudaGetLastError() after the launches (0 on success), or kNoTensorMap
// (-2) when the driver refuses a tensor map of the bf16 products.
extern "C" int bilstm_bwd_products(const float* x, const int* lens,
                                   const float* wx, const void* wx16,
                                   const float* y,
                                   const float* dg, float* dx, float* dwx,
                                   float* db, float* dwhf, float* dwhb, int B,
                                   int T, int D, int H, int ldx, int ldy,
                                   int yb, int cd_bf16, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || H <= 0 || ldx < D || yb < H ||
      ldy < yb + H) {
    return (int)cudaErrorInvalidValue;
  }
  if (K1B_WGMMA_PRODUCTS && cd_bf16 && wx16 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_products(x, ldx, lens, wx,
                         static_cast<const __nv_bfloat16*>(wx16), y, ldy, yb,
                         dg, dx, dwx, db, dwhf, dwhb, B, T, D, H, cd_bf16 != 0,
                         static_cast<cudaStream_t>(stream));
}

// K7-bwd: the VJP of the v1 layer (gluon_e2e_asr_tpu/ops/pallas_lstm.py::
// bilstm_pallas -> _bilstm_vjp_bwd -> pl.pallas_call -> _bwd_kernel):
// the reverse recurrence (the kernel H selects) and the two dW_h
// products (the route of K1-bwd's, bf16 on wgmma), without K1's
// projection products. y, cs and acts come from bilstm_v1_fwd's training
// form, y and cs rounded as the TPU kernel's streams in xg's dtype (the
// recurrence then reads the rounded c, as _bwd_kernel does). The TPU
// kernel recomputes the gate activations from xg and the rounded h
// stream. With a bf16 compute dtype that recompute is the forward's own
// product of the same rounded h, so the saved activations are the same
// values (up to the order of the sums). With bf16 projections and an f32
// compute dtype the forward's product took the unrounded h, so the caller
// first recomputes acts with bilstm_v1_gates. y holds the h stream as bilstm_bwd_products takes
// it (rows of ldy floats, the backward direction's at column yb); cs,
// acts and dy as bilstm_bwd_recur takes them. dg [B,T,8H] f32 receives
// d(xg) of both directions (forward at columns 0..4H); dwhf, dwhb [H,4H]
// f32. Returns cudaGetLastError(), kNoClusterFits or kNoTensorMap.
extern "C" int bilstm_v1_bwd(const int* lens, const void* wtf,
                             const void* wtb, const float* y, const float* cs,
                             const float* acts, const float* dy, float* dg,
                             float* dwhf, float* dwhb, int B, int T, int H,
                             int ldy, int yb, int cd_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 1024 || yb < H || ldy < yb + H) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_recurrence(dy, lens, acts, cs, wtf, wtb, dg, B, T, H,
                                   cd_bf16 ? 1 : 0, st);
  if (rc != 0) return rc;
  return launch_products(nullptr, 0, lens, nullptr, nullptr, y, ldy, yb, dg,
                         nullptr, nullptr, nullptr, dwhf, dwhb, B, T, 0, H,
                         cd_bf16 != 0, st);
}

// K7-bwd's gate recompute, for bf16 projections with an f32 compute dtype
// (the reference's _bwd_kernel forms these gates; the forward never did:
// its product took h unrounded). Per direction one f32 product over all
// B*T frames on the FMA units (gemm.cuh's gemm_f32_kernel, true f32):
// h_prev . W_h, h_prev the rounded h stream y [B,T,2H] f32 at t-1
// (forward) or t+1 (backward), 0 outside [0, T); its epilogue adds the
// projection (xf, xb [B,T,4H] bf16), takes the activations and writes
// them into acts [B,T,8H] f32 as bilstm_v1_fwd's training form lays them
// out (0 at t >= lens[b]), for bilstm_v1_bwd. whf, whb [H,4H] f32 in the
// caller's layout. Returns cudaGetLastError() after the launches.
extern "C" int bilstm_v1_gates(const void* xf, const void* xb,
                               const int* lens, const float* whf,
                               const float* whb, const float* y, float* acts,
                               int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, N4 = 4 * H, ld = 2 * H;
  for (int dir = 0; dir < 2; ++dir) {
    const float* yd = y + dir * H;
    const float* wh = dir ? whb : whf;
    const cudaError_t e = gemm::launch<false>(
        HPrev{HPrevT{yd, T, H, M, dir, ld, gemm::vec_ok(yd, ld)}},
        gemm::RowMajor{wh, N4, H, N4, gemm::vec_ok(wh, N4)},
        GateActs{static_cast<const __nv_bfloat16*>(dir ? xb : xf), lens, acts,
                 T, H, dir},
        M, N4, H, 1, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The reverse recurrence: dg [B,T,8H] f32 from lens, W_h (wtf/wtb, float
// when cd_bf16 == 0 and __nv_bfloat16 when cd_bf16 == 1, in the layout of
// the recurrence kernel that H selects: the header), K1-fwd's c stream cs
// [B,T,2H] and training-form activations acts [B,T,8H], and dy [B,T,2H],
// all f32. Returns cudaGetLastError() after the launch (0 on success), or
// kNoClusterFits (-1) without launching when no cluster of the recurrence
// fits.
extern "C" int bilstm_bwd_recur(const int* lens, const void* wtf,
                                const void* wtb, const float* cs,
                                const float* acts, const float* dy, float* dg,
                                int B, int T, int H, int cd_bf16,
                                void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_recurrence(dy, lens, acts, cs, wtf, wtb, dg, B, T, H,
                           cd_bf16 ? 1 : 0, static_cast<cudaStream_t>(stream));
}

// The plan bwd_cluster_kernel takes for B rows at hidden size H <=
// kClusterMaxHidden, weights in f32 (cd_bf16 == 0) or bf16: *R rows a
// cluster (common.cuh::cluster_rows) and *capacity, the clusters of R rows
// the device holds at once; the launch takes 2 * ceil(B / R) clusters of
// kCtas CTAs. For the record only: a launch asks the same itself. Returns
// a cudaError_t.
extern "C" int bilstm_bwd_cluster_plan(int* R, int* capacity, int B, int H,
                                       int cd_bf16, void* stream) {
  if (B <= 0 || H <= 0 || H > kClusterMaxHidden) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int U = cluster_units(H);
  return (int)cluster_rows(
      B,
      [&](int r, int* n) {
        return cd_bf16 ? bwd_capacity<__nv_bfloat16>(r, U, st, n)
                       : bwd_capacity<float>(r, U, st, n);
      },
      R, capacity);
}

extern "C" const char* bilstm_bwd_error_string(int code) {
  if (code == kNoClusterFits) {
    return "no cluster of 16 CTAs of bwd_cluster_kernel fits on this device "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  }
  if (code == gemm_sm90::kNoTensorMap) {
    return "the driver refused a tensor map of the bf16 products "
           "(cuTensorMapEncodeTiled missing, or a row stride or the "
           "backward direction's column not a multiple of 16 bytes)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
