// K4-fwd and K4-bwd: the teacher-forced LAS decoder over L steps, forward
// and backward, for Hopper (sm_90a), in the three attention modes of the
// TPU kernel: dot, add (Bahdanau) and loc (location-aware).
//
// Replace the TPU kernels gluon_e2e_asr_tpu/ops/pallas_decoder.py::
// las_decoder_fwd (pl.pallas_call at :434, body _fwd_kernel :161-304) and
// ::las_decoder_bwd (pl.pallas_call at :827, body _bwd_kernel :462-677),
// the forward and VJP of las_decoder_fused. Same math, gate order
// (i,f,g,o) with the forget bias +1 inside the cell. Every product takes
// operands rounded to the compute dtype WT (float or bf16) and sums in
// f32; state, softmax, gate math, the energies and their tanh are f32.
// Per step i and batch row b:
//
//   tok   = coin[b,i] ? argmax(previous logits) : gold[b,i]
//   gates = [embed[tok]; ctx_prev; h_prev] . [W_x; W_h] + b_x
//   c, h  = cell(gates, c_prev)
//   q     = h . att_q + att_b
//   s[t]  = (enc_proj[b,t] . q) * scale                     dot (1/sqrt(A))
//   s[t]  = sum_a v[a] tanh(enc_proj[b,t,a] + q[a] + l[t,a])  add, loc
//             l = 0 (add); l[t,a] = sum_c f[c,t] loc_proj[c,a] (loc), with
//             f[c,t] = sum_k att_prev[t+k-pad] filter[k,c], pad = (w-1)/2
//   att   = softmax(s) over t < len[b], exactly 0 past it
//   ctx   = att . enc[b]
//   logits = [h; ctx] . W_out + b_out
//
// The forward writes logits and the residuals h, c, att, ctx, tok, plus
// what the backward reads instead of recomputing: the gate activations
// (sig(i), sig(f+1), tanh(g), sig(o)) and q. The backward sweeps i = L-1
// .. 0 with the TPU backward kernel's formulas (pallas_decoder.py:510-664)
// and writes the per-step streams dgates, dctx, dqb, demb. Dot mode also
// writes the scaled score gradient dsn [B,L,T], and d_encp_kernel then
// forms d_enc_proj[b] = sum_i dsn[b,i]^T q[b,i] (the TPU kernel's
// accumulation, :564). The energy modes recompute each step's energies
// from q, enc_proj and (loc) the feature, and accumulate d_enc_proj in
// place, d_att_v and d_loc_proj as partial sums per batch row or block
// (added up by the caller in a fixed order: the same bits every run), and
// (loc) write the feature's gradient dfct [B,L,C*T] and carry dfct .
// band^T into the previous step's softmax backward (:538, :606-610). The weight
// gradients the TPU wrapper takes outside its kernel (:856-874, the
// band's among them) are the caller's.
//
// Two designs each way. For the shapes whose cluster plan does not fit,
// fwd_kernel and bwd_kernel: one block of 1024 threads owns kRows = 2
// whole batch rows for all L steps. Each step depends on the previous
// step's context, state and argmax (and, loc, attention weights), so no
// product can be hoisted out of the loop, and no block needs another
// block's rows. Each step is a few phases separated by __syncthreads:
//   - the matrix-vector products (gates, q, logits; in the backward the
//     transposed ones) share gemv_partials: a work item owns 16 bytes of
//     adjacent output columns (4 in f32, 8 in bf16) and one of S splits of
//     the depth, reads its weights as one 16-byte load a row, the threads
//     of a warp on neighbouring columns, and multiplies each weight into
//     the block's rows; the S partial sums go through shared memory;
//   - the context, and the backward's dot-mode dqb, are such products too,
//     one row at a time, the row's own frames (enc, enc_proj) its weights;
//   - the dot scores, the energies of the forward, and the backward's
//     attention gradient, 8 lanes per (row, frame), along the enc_proj /
//     enc row 16 bytes at a time;
//   - the backward's energies (energy_bwd) over chunks of frames, kELanes
//     lanes per (row, frame), d_enc_proj updated in place (a block owns
//     its rows: no atomics), the sums over frames through a tile in shared
//     memory;
//   - the location feature as a convolution with the w x C filter in
//     shared memory (w*C*T multiply-adds a row, where the TPU kernel's
//     band product takes T*C*T and re-reads a T x C*T band every step),
//     and the backward's carry as the matching correlation;
//   - softmax and argmax (the first maximum, as jnp.argmax), one warp a row.
// Every step every block streams all the weights from L2: W_x and W_h
// stacked, (E+D+H) x 4H = 1216 x 1280 at the flagship's width (E=256,
// D=640, H=A=320, V=32), 3.1 MB in bf16; att_q and W_out 0.26 MB. Each
// loaded weight feeds two rows, and the stream is bound by the loads one
// SM keeps in flight, not by their bytes: about 40 us a step in bf16. At
// B=96 the 48 blocks leave 84 of the H100's 132 SMs idle.
//
// bwd_cluster_kernel, K4-bwd for every shape whose plan (ClBwdSmem) fits
// 227 KB: a cluster of kCl = 8 CTAs owns 8 batch rows, CTA r row b0 + r,
// for the whole sweep; at B=96, 12 clusters, 96 CTAs in one wave. R = 8
// is the portable cluster size and makes every column slice at the
// flagship's widths a multiple of 8 (H/8 = 40, D/8 = 80, E/8 = 32); 16
// would halve each CTA's weight stream but leave 20-unit slices and
// non-portable clusters. Per step:
//   (a) the head's input (the 8 rows' rounded dlogits) and the cell's
//       saved activations and c of this CTA's units, for the 8 rows;
//   (b) the head, d[h; ctx] = dlogits . W_out^T, for this CTA's H/8 units
//       and D/8 context columns of the 8 rows (cl_product); exchange 1
//       sends each row's context columns to the row's CTA;
//   (c) the row's own phases, in its CTA alone, the frames whole: the
//       attention gradient's frame dots, the softmax backward (loc: the
//       carry added first), dot's dqb = dsn . enc_proj and dsn; add/loc's
//       energy phase at one row (energy_bwd, chunks of kClTile = 64
//       frames: 64 frames x 16 lanes = 1024 threads), loc's feature and
//       carry; exchange 2 sends the row's dqb to every CTA;
//   (d) the query's gradient dqb . att_q^T into this CTA's units, and
//       their cells for the 8 rows (acts and c from step (a)); exchange 3
//       sends the units' rounded dgates to every CTA;
//   (e) dgates . [W_x; W_h]^T into this CTA's E/8, D/8 and H/8 columns:
//       demb to device memory, the context and h carries kept here for the
//       next step's head, which owns the same columns.
// So each loaded weight feeds 8 rows, and each CTA streams 1/8 of the
// weights, as per-CTA slices the wrapper lays out contiguously, depth-major
// ([K][N_r]). A CTA whose row is past B (the last cluster of a batch that
// is not a multiple of 8) has no frames and writes no row, but computes
// its columns of the products for the cluster's other rows.
// The products stay on the CUDA cores (cl_product): a warp takes 16 groups
// of 4 columns and a split of the depth, each lane 4 of the 8 rows of one
// group (acc[4][4]: 1024 threads leave 64 registers a thread) with 64
// bytes of weights in flight; the lanes read the rows' input as a
// broadcast from shared memory, and a warp's weight load is one run of
// 128 bytes that its two row halves share. A CTA's products at the
// flagship's widths are 1.7 M multiply-adds a step (6.5 us at one SM's f32
// FMA rate) over 0.42 MB of bf16 weights from L2.
// The row's own phases are the two-row design's at one row (energy_bwd
// with 64-frame chunks, each sum over frames four frames a round), except
// the loc feature and carry (loc_feature_row, loc_carry_row: four frames
// a thread over a zero-padded sliding window) and the attention
// gradient's frame dots (frame_dots_row: four loads in flight a lane),
// each summing in the two-row design's order.
// What bounds it on an H100 at the flagship's widths (tools/k4_probe.py
// --phases): a dot step at the 4.0 s bucket takes about 43 us, half of
// it the gate product (about 20 us, at half the CUDA cores' instruction
// rate) and about 2 us each the other phases and exchanges; a loc step at
// T'=320 about 200 us, 140 of it the energy phase, whose frame loop
// reads enc_proj (20 MB a step over the batch, bf16) and reads and writes
// d_enc_proj (39 MB each way, f32) in device memory.
// Each exchange is a store through distributed shared memory
// (cluster.map_shared_rank) into a receive slot, then one cluster barrier
// split into its arrival and its wait. One buffer a slot is enough here
// (bilstm_bwd.cu's cluster recurrence, one barrier a step, needs two): a
// slot is read before its reader's next arrival, and the next store into
// it comes after a later barrier that waits for that arrival. Every CTA
// reaches every barrier the same number of times (a row past B, a row
// with no frames and loc's chunk loop use __syncthreads alone), and the
// sweep ends with a cluster barrier, after the last store into another
// CTA. bwd_route picks the kernel by shape alone; when no cluster fits on
// the device the launch returns kNoClusterFits, and nothing falls back.
//
// fwd_cluster_kernel, K4-fwd for every shape whose plan (ClFwdSmem) fits,
// on the same layout turned forward: a cluster of kCl = 8 CTAs owns 8
// batch rows, CTA r row b0 + r, for all L steps, and HU = H/8 hidden
// units and AU = A/8 query columns of the cluster's rows. Per step i:
//   (a) the gate input of the 8 rows, [emb(tok_i); ctx_{i-1}; h_{i-1}]
//       rounded, as cl_product reads it: each CTA gathers the 8 rows'
//       embeddings itself from the tokens of exchange 3; ctx came by
//       exchange 3 and h by exchange 1 of step i-1;
//   (b) the gate product into this CTA's 4 HU gate columns (its units'
//       i, f, g, o; cl_product over E+D+H) and the cells of its units for
//       the 8 rows, c kept here; exchange 1 sends the units' rounded h to
//       every CTA's gate input, which is also the query's input;
//   (c) the query product into this CTA's AU columns for the 8 rows, plus
//       att_b; exchange 2 sends row r's columns to CTA r;
//   (d) the row's own phases, in its CTA alone, the frames whole: loc's
//       feature from the previous step's weights (loc_feature_row), the
//       scores (frame_dots_row; add and loc frame_energies at one row),
//       the masked softmax (one warp), the context att . enc[b] (gemv_rows
//       at one row), the logits [h; ctx] . W_out + b_out of the row (W_out
//       whole from L2: 30 K multiply-adds a step, 0.06 MB in bf16), the
//       argmax and the next token (the coin's choice); exchange 3 sends
//       the row's rounded ctx and next token to every CTA.
// So each loaded gate or query weight feeds 8 rows and each CTA streams
// 1/8 of them (slices laid out as the backward's); the logits stay in the
// row's CTA (V/8 columns a CTA would need a fourth exchange for the
// argmax). The row's phases are the two-row design's at one row and sum
// in its order; only the two products' sums run in cl_product's order.
// The exchanges are the backward's: a store through distributed shared
// memory, then one split cluster barrier. One buffer a slot would be
// enough for the query (stored by exchange 2 of step i and read in (d);
// the next store follows the wait of exchange 1 of step i+1, which needs
// every CTA's arrival there, after its (d) of step i), the tokens (read
// in (a) of step i+1; the next store follows exchange 2 of step i+1) and
// ctx (read by the gate product of step i+1; the next store follows
// exchange 2 of step i+1 too). Not for h: CTA r stores h_{i+1} into CTA
// s after the wait of exchange 3 of step i, which orders it after s's
// query product of step i but not after s's gate product of step i+1,
// which still reads h_i. So the gate input is two buffers by step
// parity, as the K1 cluster recurrences' receive
// slots are: step i reads buffer i % 2 and fills buffer (i+1) % 2, whose
// last reader, the gate product of step i-1, ended before exchange 1 of
// step i-1. Every CTA reaches every barrier the same number of times (a
// row past B or without frames computes its columns for the others), and
// every sum runs in a fixed order: the same bits every run. fwd_route
// picks the kernel by shape alone; kNoClusterFits raises, as the
// backward's. What bounds it on an H100 at the flagship's widths
// (tools/k4_probe.py --phases, bf16): a dot step at the 4.0 s bucket
// takes about 43 us (the two-row design's about 65), 19 of it the gate
// product (K4-bwd's product, at about half the CUDA cores' instruction
// rate), about 4.6 exchange 3 (8 D scalar stores a CTA into the cluster,
// each row's ctx strided by its lane of the gate input), about 3 each
// the context and the logits, 1-2.7 each the rest; a loc step at T'=320
// about 91 us, 43 of it the energies (per frame and column C feature
// products and a tanh, their operands from shared memory).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// 1: K4-bwd takes bwd_cluster_kernel for every shape whose plan fits; 0:
// the build variant with bwd_kernel alone, the design before it, kept for
// timing beside it (tools/k4_probe.py).
#define K4B_CLUSTER 1

// 1: thread 0 of the first CTA adds the SM cycles of each phase of
// bwd_cluster_kernel's steps to k4b_phase_cycles, which
// las_decoder_bwd_phase_cycles reads and clears (the build variant of
// tools/k4_probe.py --phases); 0: no counting.
#define K4B_TIMING 0
constexpr int kPhases = 16;
#if K4B_TIMING
__device__ unsigned long long k4b_phase_cycles[kPhases];
__shared__ long long k4b_acc_[kPhases];  // counted here, added up at the end
__shared__ long long k4b_t0_;
#define K4B_PHASE(p)                             \
  do {                                           \
    if (threadIdx.x == 0 && blockIdx.x == 0) {   \
      const long long now_ = clock64();          \
      k4b_acc_[p] += now_ - k4b_t0_;             \
      k4b_t0_ = now_;                            \
    }                                            \
  } while (0)
#else
#define K4B_PHASE(p)
#endif

// 1: K4-fwd takes fwd_cluster_kernel for every shape whose plan fits; 0:
// the build variant with fwd_kernel alone, the design before it, kept for
// timing beside it (tools/k4_probe.py).
#define K4F_CLUSTER 1

// 1: thread 0 of the first CTA adds the SM cycles of each phase of
// fwd_cluster_kernel's steps to k4f_phase_cycles, which
// las_decoder_fwd_phase_cycles reads and clears (tools/k4_probe.py
// --phases); 0: no counting.
#define K4F_TIMING 0
constexpr int kFwdPhases = 13;
#if K4F_TIMING
__device__ unsigned long long k4f_phase_cycles[kFwdPhases];
__shared__ long long k4f_acc_[kFwdPhases];
__shared__ long long k4f_t0_;
#define K4F_PHASE(p)                             \
  do {                                           \
    if (threadIdx.x == 0 && blockIdx.x == 0) {   \
      const long long now_ = clock64();          \
      k4f_acc_[p] += now_ - k4f_t0_;             \
      k4f_t0_ = now_;                            \
    }                                            \
  } while (0)
#else
#define K4F_PHASE(p)
#endif

namespace cg = cooperative_groups;

namespace {

using port::kNoClusterFits;
constexpr int kRouteMismatch = -2;

constexpr int kThreads = 1024;
constexpr int kRows = 2;       // batch rows per block
constexpr int kMaxSplit = 32;  // depth splits of a matrix-vector product
constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxLocC = 16;    // location channels (dfct's sums in registers)
constexpr int kLocTile = 32;    // frames of a backward energy chunk
constexpr int kELanes = 16;     // lanes per (row, frame) of the backward energies
static_assert(kRows * kLocTile * kELanes == kThreads,
              "one backward energy group per (row, frame) of a chunk");

// The attention modes, as the C interface numbers them.
enum Mode { kDot = 0, kAdd = 1, kLoc = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the compute dtype (kept in f32).
template <typename WT>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) { return port::round_bf16(x); }

// 16 bytes of weights, the widest load a thread issues: 4 f32 or 8 bf16
// values of adjacent columns, loaded raw and widened to f32 at use.
template <typename WT>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void unpack(const Raw& q, float (&x)[kN]) {
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const Raw& q, float (&x)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
};

// Depth splits of a product with N outputs in groups of `cols` columns.
__host__ __device__ inline int gemv_splits(int N, int threads, int cols) {
  const int groups = (N + cols - 1) / cols;
  const int s = threads / groups;
  return s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
}

__host__ __device__ inline size_t align4(size_t floats) { return (floats + 3) & ~(size_t)3; }

__host__ __device__ inline size_t part_floats(int N, int cols) {
  return (size_t)gemv_splits(N, kThreads, cols) * kRows * N;
}

template <int NR, int C>
__device__ __forceinline__ void fma_rows(const float* v, int ldv, int k,
                                         const float (&w)[C],
                                         float (&acc)[NR][C]) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float x = v[r * ldv + k];
#pragma unroll
    for (int e = 0; e < C; ++e) acc[r][e] = fmaf(x, w[e], acc[r][e]);
  }
}

// part[(s * NR + r) * N + n] = sum over split s of the depth K of
// v[r * ldv + k] * W[k * N + n], for the NR rows r that share W. W is
// [K][N] row-major in the compute dtype; v is in shared memory. A work
// item owns C = Pack<WT>::kN adjacent columns and loads 16 bytes of a
// weight row at once; it issues U such loads before it multiplies any.
// The loads come from L2 (or device memory) and the product is bound by
// how many are in flight, not by the bytes. Ends without a barrier: the
// caller synchronises before reading part.
template <typename WT, int NR>
__device__ void gemv_partials(const float* v, int ldv, int K,
                              const WT* __restrict__ W, int N, float* part) {
  using P = Pack<WT>;
  constexpr int C = P::kN;
  constexpr int U = 32 / C;
  const int G = (N + C - 1) / C;
  const int S = gemv_splits(N, blockDim.x, C);
  const int kc = (K + S - 1) / S;
  const bool vec = N % C == 0;
  for (int item = threadIdx.x; item < G * S; item += blockDim.x) {
    const int g = item % G, s = item / G;
    const int n0 = C * g;
    const int k0 = s * kc, k1 = min(K, k0 + kc);
    float acc[NR][C];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int e = 0; e < C; ++e) acc[r][e] = 0.0f;
    int k = k0;
    if (vec) {
      for (; k + U <= k1; k += U) {
        typename P::Raw q[U];
#pragma unroll
        for (int j = 0; j < U; ++j) q[j] = P::load(W + (size_t)(k + j) * N + n0);
#pragma unroll
        for (int j = 0; j < U; ++j) {
          float w[C];
          P::unpack(q[j], w);
          fma_rows<NR, C>(v, ldv, k + j, w, acc);
        }
      }
      for (; k < k1; ++k) {
        float w[C];
        P::unpack(P::load(W + (size_t)k * N + n0), w);
        fma_rows<NR, C>(v, ldv, k, w, acc);
      }
    } else {
      for (; k < k1; ++k) {
        float w[C];
#pragma unroll
        for (int e = 0; e < C; ++e)
          w[e] = n0 + e < N ? to_f(W[(size_t)k * N + n0 + e]) : 0.0f;
        fma_rows<NR, C>(v, ldv, k, w, acc);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int e = 0; e < C; ++e)
        if (n0 + e < N) part[((size_t)s * NR + r) * N + n0 + e] = acc[r][e];
  }
}

// The finished sum of output (r, n) of NR rows, in the fixed order of the
// splits.
template <typename WT, int NR>
__device__ __forceinline__ float gemv_sum(const float* part, int N, int r,
                                          int n) {
  const int S = gemv_splits(N, blockDim.x, Pack<WT>::kN);
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[((size_t)s * NR + r) * N + n];
  return acc;
}

// The per-row products (the context, dqb): row r's weights are its own
// encoder frames, so each row is a one-row product with its own partials.
template <typename WT, int NR = kRows>
__device__ void gemv_rows(const float* v, int ldv, const int* len,
                          const WT* __restrict__ W, size_t row_stride, int N,
                          float* part) {
  const size_t per_row = (size_t)gemv_splits(N, blockDim.x, Pack<WT>::kN) * N;
  for (int r = 0; r < NR; ++r)
    gemv_partials<WT, 1>(v + r * ldv, 0, len[r], W + r * row_stride, N,
                         part + r * per_row);
}

template <typename WT>
__device__ __forceinline__ float gemv_row_sum(const float* part, int N, int r,
                                              int n) {
  const size_t per_row = (size_t)gemv_splits(N, blockDim.x, Pack<WT>::kN) * N;
  return gemv_sum<WT, 1>(part + r * per_row, N, 0, n);
}

// out[r * T + t] = scale * (x[r * ldx + :] . frame t of row r) for
// t < len[r], where frame t of row r is rows[r * row_stride + t * N + :]
// (the scores from enc_proj, the backward's attention gradient from enc).
// A group of kDotLanes lanes takes one (row, frame) and reads it 16 bytes
// at a time, so a warp has several frames' loads in flight at once.
constexpr int kDotLanes = 8;

template <typename WT>
__device__ void frame_dots(const WT* __restrict__ rows, size_t row_stride,
                           int N, const float* x, int ldx, const int* len,
                           int T, float scale, float* out) {
  const int lane = threadIdx.x % 32, sl = lane % kDotLanes;
  const int per_warp = 32 / kDotLanes;
  const int first = threadIdx.x / 32 * per_warp + lane / kDotLanes;
  const int step = blockDim.x / 32 * per_warp;
  const int total = kRows * T;
  using P = Pack<WT>;
  constexpr int C = P::kN;
  const bool vec = N % C == 0;
  // Warp-uniform trip count: every lane reaches the shuffles.
  for (int base = first - lane / kDotLanes; base < total; base += step) {
    const int it = base + lane / kDotLanes;
    const int r = it / T, t = it % T;
    const bool on = it < total && t < len[r];
    float acc = 0.0f;
    if (on) {
      const WT* e = rows + r * row_stride + (size_t)t * N;
      const float* xr = x + r * ldx;
      if (vec) {
        for (int n = C * sl; n < N; n += C * kDotLanes) {
          float w[C];
          P::unpack(P::load(e + n), w);
#pragma unroll
          for (int j = 0; j < C; ++j) acc = fmaf(xr[n + j], w[j], acc);
        }
      } else {
        for (int n = sl; n < N; n += kDotLanes) acc = fmaf(xr[n], to_f(e[n]), acc);
      }
    }
#pragma unroll
    for (int o = kDotLanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (on && sl == 0) out[r * T + t] = acc * scale;
  }
}

// frame_dots for the one row of a block (len n), each lane's 16-byte
// loads of a frame issued four at a time before their products; the sum
// runs in frame_dots' order, and is scaled as there: the same bits.
template <typename WT>
__device__ void frame_dots_row(const WT* __restrict__ rows, int N,
                               const float* x, int n, int T, float* out,
                               float scale = 1.0f) {
  using P = Pack<WT>;
  constexpr int C = P::kN, U = 4, SPAN = C * kDotLanes;
  const int lane = threadIdx.x % 32, sl = lane % kDotLanes;
  const int per_warp = 32 / kDotLanes;
  const int first = threadIdx.x / 32 * per_warp + lane / kDotLanes;
  const int step = blockDim.x / 32 * per_warp;
  const bool vec = N % C == 0;
  for (int base = first - lane / kDotLanes; base < T; base += step) {
    const int t = base + lane / kDotLanes;
    const bool on = t < n;
    float acc = 0.0f;
    if (on) {
      const WT* e = rows + (size_t)t * N;
      if (vec) {
        int m = C * sl;
        for (; m + (U - 1) * SPAN < N; m += U * SPAN) {
          typename P::Raw q[U];
#pragma unroll
          for (int j = 0; j < U; ++j) q[j] = P::load(e + m + j * SPAN);
#pragma unroll
          for (int j = 0; j < U; ++j) {
            float w[C];
            P::unpack(q[j], w);
#pragma unroll
            for (int c = 0; c < C; ++c) acc = fmaf(x[m + j * SPAN + c], w[c], acc);
          }
        }
        for (; m < N; m += SPAN) {
          float w[C];
          P::unpack(P::load(e + m), w);
#pragma unroll
          for (int c = 0; c < C; ++c) acc = fmaf(x[m + c], w[c], acc);
        }
      } else {
        for (int m = sl; m < N; m += kDotLanes) acc = fmaf(x[m], to_f(e[m]), acc);
      }
    }
#pragma unroll
    for (int o = kDotLanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (on && sl == 0) out[t] = acc * scale;
  }
}

// The energy scores of add and loc mode for NR rows (the two-row block's,
// or the one row of a cluster CTA), with frame_dots' lane layout:
// out[r * T + t] = sum_a v[a] tanh(e[a]) for t < len[r], where
// e[a] = enc_proj[r,t,a] + qb[r * A + a] (+ sum_c f[(r*C + c)*T + t]
// locp[c * A + a] in loc mode, that sum formed first, as the TPU kernel
// adds the feature's product to the energy, pallas_decoder.py:259-271).
// qb, v, locp and f are in shared memory, v and locp 16-byte aligned; f
// and locp are rounded.
template <typename WT, bool LOC, int NR = kRows>
__device__ void frame_energies(const WT* __restrict__ rows, size_t row_stride,
                               int A, const float* qb, const float* v,
                               const float* locp, const float* f, int C,
                               const int* len, int T, float* out) {
  const int lane = threadIdx.x % 32, sl = lane % kDotLanes;
  const int per_warp = 32 / kDotLanes;
  const int first = threadIdx.x / 32 * per_warp + lane / kDotLanes;
  const int step = blockDim.x / 32 * per_warp;
  const int total = NR * T;
  using P = Pack<WT>;
  constexpr int CN = P::kN;
  const bool vec = A % CN == 0;
  for (int base = first - lane / kDotLanes; base < total; base += step) {
    const int it = base + lane / kDotLanes;
    const int r = it / T, t = it % T;
    const bool on = it < total && t < len[r];
    float acc = 0.0f;
    if (on) {
      const WT* e = rows + r * row_stride + (size_t)t * A;
      const float* q = qb + r * A;
      const float* fr = f + (size_t)r * C * T + t;
      if (vec) {
        for (int n = CN * sl; n < A; n += CN * kDotLanes) {
          float x[CN];
          P::unpack(P::load(e + n), x);
#pragma unroll
          for (int j = 0; j < CN; ++j) x[j] += q[n + j];
          if constexpr (LOC) {
            float fl[CN];
#pragma unroll
            for (int j = 0; j < CN; ++j) fl[j] = 0.0f;
            for (int c = 0; c < C; ++c) {
              const float fc = fr[c * T];
              const float4* lp = reinterpret_cast<const float4*>(locp + c * A + n);
#pragma unroll
              for (int q4 = 0; q4 < CN / 4; ++q4) {
                const float4 l = lp[q4];
                fl[4 * q4] = fmaf(fc, l.x, fl[4 * q4]);
                fl[4 * q4 + 1] = fmaf(fc, l.y, fl[4 * q4 + 1]);
                fl[4 * q4 + 2] = fmaf(fc, l.z, fl[4 * q4 + 2]);
                fl[4 * q4 + 3] = fmaf(fc, l.w, fl[4 * q4 + 3]);
              }
            }
#pragma unroll
            for (int j = 0; j < CN; ++j) x[j] += fl[j];
          }
          const float4* v4 = reinterpret_cast<const float4*>(v + n);
#pragma unroll
          for (int q4 = 0; q4 < CN / 4; ++q4) {
            const float4 vq = v4[q4];
            acc = fmaf(vq.x, tanhf(x[4 * q4]), acc);
            acc = fmaf(vq.y, tanhf(x[4 * q4 + 1]), acc);
            acc = fmaf(vq.z, tanhf(x[4 * q4 + 2]), acc);
            acc = fmaf(vq.w, tanhf(x[4 * q4 + 3]), acc);
          }
        }
      } else {
        for (int n = sl; n < A; n += kDotLanes) {
          float x = to_f(e[n]) + q[n];
          if constexpr (LOC) {
            float fl = 0.0f;
            for (int c = 0; c < C; ++c) fl = fmaf(fr[c * T], locp[c * A + n], fl);
            x += fl;
          }
          acc = fmaf(v[n], tanhf(x), acc);
        }
      }
    }
#pragma unroll
    for (int o = kDotLanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (on && sl == 0) out[r * T + t] = acc;
  }
}

// The location feature of loc mode, f[(r*C + c)*T + t] = rounded
// sum_k att[r*T + t + k - pad] filt[k*C + c] for t < len[r] (0 past it),
// pad = (W-1)/2: the product of the rounded weights with the TPU kernel's
// band (pallas_decoder.py:238-243; band[s, c*T + t] = filter[s - t + pad,
// c]) as the convolution it is, over the frames s in [0, len[r]) (att is 0
// past the length). att (rounded) and filt (rounded, [W][C]) in shared
// memory.
template <typename WT>
__device__ void loc_feature(const float* att, const float* filt, int C, int W,
                            const int* len, int T, float* f) {
  const int pad = (W - 1) / 2;
  for (int it = threadIdx.x; it < kRows * C * T; it += blockDim.x) {
    const int r = it / (C * T), c = (it / T) % C, t = it % T, n = len[r];
    if (t >= n) {
      f[it] = 0.0f;
      continue;
    }
    const int k0 = max(0, pad - t), k1 = min(W, n - t + pad);
    const float* ar = att + r * T + t - pad;
    float acc = 0.0f;
    for (int k = k0; k < k1; ++k) acc = fmaf(ar[k], filt[k * C + c], acc);
    f[it] = rnd<WT>(acc);
  }
}

// The loc backward's carry into the previous step's attention weights,
// datt[r*T + s] = sum_{c,t} dfct[(r*C + c)*T + t] filt[(s - t + pad)*C + c]
// for s < len[r] (0 past it): dfct . band^T of pallas_decoder.py:606-610
// as a correlation, over t < len[r] (dfct is 0 past the length). dfct is
// rounded. The per-channel sums go through part [kRows*C*T] and are added
// in channel order; ends with a barrier.
template <typename WT>
__device__ void loc_carry(const float* dfct, const float* filt, int C, int W,
                          const int* len, int T, float* part, float* datt) {
  const int pad = (W - 1) / 2;
  for (int it = threadIdx.x; it < kRows * C * T; it += blockDim.x) {
    const int r = it / (C * T), c = (it / T) % C, s = it % T, n = len[r];
    float acc = 0.0f;
    if (s < n) {
      const int t0 = max(0, s + pad - W + 1), t1 = min(n - 1, s + pad);
      const float* dr = dfct + (r * C + c) * T;
      for (int t = t0; t <= t1; ++t)
        acc = fmaf(dr[t], filt[(s - t + pad) * C + c], acc);
    }
    part[it] = acc;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < kRows * T; it += blockDim.x) {
    const int r = it / T, s = it % T;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += part[(r * C + c) * T + s];
    datt[it] = acc;
  }
  __syncthreads();
}

// loc_feature for the one row of a block, four consecutive frames a
// thread: attz holds the row's rounded weights at attz[pad + s] and zeros
// around them (pad before, W + 3 after), so each tap brings one new word
// into a sliding window of four, the taps past the frames add zeros, and
// each frame's sum runs in loc_feature's order: the same bits.
template <typename WT>
__device__ void loc_feature_row(const float* attz, const float* filt, int C,
                                int W, int n, int T, float* f) {
  const int TQ = (T + 3) / 4;
  for (int it = threadIdx.x; it < C * TQ; it += blockDim.x) {
    const int c = it / TQ, t0 = 4 * (it % TQ);
    const float* x = attz + t0;
    float x0 = x[0], x1 = x[1], x2 = x[2];
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < W; ++k) {
      const float x3 = x[k + 3], w = filt[k * C + c];
      y[0] = fmaf(x0, w, y[0]);
      y[1] = fmaf(x1, w, y[1]);
      y[2] = fmaf(x2, w, y[2]);
      y[3] = fmaf(x3, w, y[3]);
      x0 = x1, x1 = x2, x2 = x3;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (t0 + q < T) f[c * T + t0 + q] = t0 + q < n ? rnd<WT>(y[q]) : 0.0f;
  }
}

// loc_carry for the one row of a block, four consecutive frames s a
// thread: dfct [C][T] (0 past n) is first copied into part as rows of
// T + 2W + 4 with W zeros before, so each frame's taps t = s + pad - W +
// 1 .. s + pad are a sliding window, the taps outside [0, n) add zeros,
// and each (channel, frame) sum runs in loc_carry's order; the per-channel
// sums follow in part and are added in channel order: the same bits. Ends
// with a barrier.
template <typename WT>
__device__ void loc_carry_row(const float* dfct, const float* filt, int C,
                              int W, int n, int T, float* part, float* datt) {
  const int pad = (W - 1) / 2, TS = T + 2 * W + 4, TQ = (T + 3) / 4;
  float* sums = part + (size_t)C * TS;
  for (int it = threadIdx.x; it < C * TS; it += blockDim.x) {
    const int c = it / TS, t = it % TS - W;
    part[it] = t >= 0 && t < n ? dfct[c * T + t] : 0.0f;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < C * TQ; it += blockDim.x) {
    const int c = it / TQ, s0 = 4 * (it % TQ);
    const float* x = part + (size_t)c * TS + s0 + pad + 1;
    float x0 = x[0], x1 = x[1], x2 = x[2];
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int m = 0; m < W; ++m) {
      const float x3 = x[m + 3], w = filt[(W - 1 - m) * C + c];
      y[0] = fmaf(x0, w, y[0]);
      y[1] = fmaf(x1, w, y[1]);
      y[2] = fmaf(x2, w, y[2]);
      y[3] = fmaf(x3, w, y[3]);
      x0 = x1, x1 = x2, x2 = x3;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (s0 + q < T) sums[c * T + s0 + q] = s0 + q < n ? y[q] : 0.0f;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < T; s += blockDim.x) {
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += sums[c * T + s];
    datt[s] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct FwdArgs {
  const int* tokens;       // [B,L]
  const uint8_t* coins;    // [B,L]
  const int* enc_len;      // [B]
  const void* enc;         // [B,T,D] WT
  const void* encp;        // [B,T,A] WT
  const void* embed;       // [V,E] WT
  const void* wcat;        // [E+D+H][4H] WT: W_x over W_h
  const float* b_x;        // [4H]
  const void* att_q;       // [H][A] WT
  const float* att_b;      // [A]
  const float* att_v;      // [A] (add, loc)
  const float* loc_filt;   // [W][C], rounded to WT (loc)
  const float* loc_proj;   // [C][A], rounded to WT (loc)
  const void* w_out;       // [H+D][V] WT
  const float* b_out;      // [V]
  float* logits;           // [B,L,V]
  float* h_seq;            // [B,L,H]
  float* c_seq;            // [B,L,H]
  float* acts;             // [B,L,4H]
  float* q_seq;            // [B,L,A]
  float* att_seq;          // [B,L,T]
  float* ctx_seq;          // [B,L,D]
  int* tok_seq;            // [B,L]
  int B, L, T, D, A, E, H, V, C, W;
  float scale;
};

// Shared-memory plan of the forward, in floats. The energy modes append
// their constants (v; loc: loc_proj, the filter) and loc the feature.
struct FwdSmem {
  size_t xv, hc, cs, q, sc, lg, part, v, locp, filt, f, total;
  __host__ __device__ FwdSmem(int mode, int T, int D, int A, int E, int H,
                             int V, int C, int W, int cols) {
    size_t o = 0;
    xv = o; o += (size_t)kRows * (E + D + H);  // [emb; ctx; h], rounded
    hc = o; o += (size_t)kRows * (H + D);      // [h; ctx], rounded
    cs = o; o += (size_t)kRows * H;            // c, f32
    q = o; o += (size_t)kRows * A;
    sc = o; o += (size_t)kRows * T;            // scores, then weights
    lg = o; o += (size_t)kRows * V;
    part = o;
    const int outs[] = {4 * H, A, V, D};  // the products' widths
    size_t p = 0;
    for (int n : outs)
      if (part_floats(n, cols) > p) p = part_floats(n, cols);
    o = align4(o + p);  // the energy modes' regions start 16-byte aligned
    v = o; o = align4(o + (mode == kDot ? 0 : (size_t)A));
    locp = o; o = align4(o + (mode == kLoc ? (size_t)C * A : 0));
    filt = o; o = align4(o + (mode == kLoc ? (size_t)W * C : 0));
    f = o; o += mode == kLoc ? (size_t)kRows * C * T : 0;
    total = o;
  }
};

template <typename WT, int MODE>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int tok_s[kRows], pred_s[kRows], len_s[kRows];
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V, C = a.C, W = a.W;
  const int KX = E + D + H, HD = H + D, H4 = 4 * H;
  const FwdSmem plan(MODE, T, D, A, E, H, V, C, W, Pack<WT>::kN);
  float* xv = sm + plan.xv;
  float* hc = sm + plan.hc;
  float* cs = sm + plan.cs;
  float* q = sm + plan.q;
  float* sc = sm + plan.sc;
  float* lg = sm + plan.lg;
  float* part = sm + plan.part;
  float* v_s = sm + plan.v;
  float* locp_s = sm + plan.locp;
  float* filt_s = sm + plan.filt;
  float* f_s = sm + plan.f;
  const WT* enc = static_cast<const WT*>(a.enc);
  const WT* encp = static_cast<const WT*>(a.encp);
  const WT* embed = static_cast<const WT*>(a.embed);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int b0 = blockIdx.x * kRows;

  for (int k = tid; k < (int)plan.part; k += nt) sm[k] = 0.0f;
  if constexpr (MODE != kDot) {
    for (int k = tid; k < A; k += nt) v_s[k] = a.att_v[k];
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; k < C * A; k += nt) locp_s[k] = a.loc_proj[k];
    for (int k = tid; k < W * C; k += nt) filt_s[k] = a.loc_filt[k];
  }
  if (tid < kRows) {
    pred_s[tid] = 0;
    len_s[tid] = b0 + tid < B ? min(max(a.enc_len[b0 + tid], 0), T) : 0;
  }
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    // The step's token and its embedding.
    if (tid < kRows) {
      const int b = b0 + tid;
      int tok = 0;
      if (b < B) {
        const size_t at = (size_t)b * L + i;
        tok = a.coins[at] ? pred_s[tid] : a.tokens[at];
        a.tok_seq[at] = tok;
      }
      tok_s[tid] = tok;
    }
    __syncthreads();
    for (int k = tid; k < kRows * E; k += nt) {
      const int r = k / E, e = k % E;
      xv[r * KX + e] = b0 + r < B ? to_f(embed[(size_t)tok_s[r] * E + e]) : 0.0f;
    }
    __syncthreads();

    // Gates and the cell.
    gemv_partials<WT, kRows>(xv, KX, KX, static_cast<const WT*>(a.wcat), H4, part);
    __syncthreads();
    for (int k = tid; k < kRows * H; k += nt) {
      const int r = k / H, u = k % H, b = b0 + r;
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = a.b_x[j * H + u] + gemv_sum<WT, kRows>(part, H4, r, j * H + u);
      const float si = port::sigmoid(g[0]);
      const float sf = port::sigmoid(g[1] + 1.0f);
      const float tg = tanhf(g[2]);
      const float so = port::sigmoid(g[3]);
      const float c = sf * cs[r * H + u] + si * tg;
      const float h = so * tanhf(c);
      cs[r * H + u] = c;
      const float hr = rnd<WT>(h);
      xv[r * KX + E + D + u] = hr;  // the next step's gate input
      hc[r * HD + u] = hr;
      if (b < B) {
        const size_t at = (size_t)b * L + i;
        a.h_seq[at * H + u] = h;
        a.c_seq[at * H + u] = c;
        float* ac = a.acts + at * H4;
        ac[u] = si;
        ac[H + u] = sf;
        ac[2 * H + u] = tg;
        ac[3 * H + u] = so;
      }
    }
    __syncthreads();

    // The attention query.
    gemv_partials<WT, kRows>(hc, HD, H, static_cast<const WT*>(a.att_q), A, part);
    __syncthreads();
    for (int k = tid; k < kRows * A; k += nt) {
      const int r = k / A, n = k % A, b = b0 + r;
      const float v = a.att_b[n] + gemv_sum<WT, kRows>(part, A, r, n);
      q[r * A + n] = v;
      if (b < B) a.q_seq[((size_t)b * L + i) * A + n] = v;
    }
    __syncthreads();

    // Scores.
    if constexpr (MODE == kDot) {
      frame_dots(encp + (size_t)b0 * T * A, (size_t)T * A, A, q, A, len_s, T,
                 a.scale, sc);
    } else {
      if constexpr (MODE == kLoc) {
        // sc still holds the previous step's weights, rounded (zeros at
        // step 0): the feature's input.
        loc_feature<WT>(sc, filt_s, C, W, len_s, T, f_s);
        __syncthreads();
      }
      frame_energies<WT, MODE == kLoc>(encp + (size_t)b0 * T * A,
                                       (size_t)T * A, A, q, v_s, locp_s, f_s,
                                       C, len_s, T, sc);
    }
    __syncthreads();

    // Masked softmax: one warp per row; exactly 0 past the row's length.
    for (int r = warp; r < kRows; r += nw) {
      const int n = len_s[r], b = b0 + r;
      float m = kNeg;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[r * T + t]);
      m = warp_max(m);
      float z = 0.0f;
      for (int t = lane; t < n; t += 32) z += expf(sc[r * T + t] - m);
      z = warp_sum(z);
      for (int t = lane; t < T; t += 32) {
        const float w = t < n ? expf(sc[r * T + t] - m) / z : 0.0f;
        sc[r * T + t] = rnd<WT>(w);  // the context's (and loc's) operand
        if (b < B) a.att_seq[((size_t)b * L + i) * T + t] = w;
      }
    }
    __syncthreads();

    // Context: ctx[r] = att[r] . enc[r], each row's frames its own weights.
    gemv_rows(sc, T, len_s, enc + (size_t)b0 * T * D, (size_t)T * D, D, part);
    __syncthreads();
    for (int k = tid; k < kRows * D; k += nt) {
      const int r = k / D, d = k % D, b = b0 + r;
      const float acc = gemv_row_sum<WT>(part, D, r, d);
      const float cr = rnd<WT>(acc);
      xv[r * KX + E + d] = cr;
      hc[r * HD + H + d] = cr;
      if (b < B) a.ctx_seq[((size_t)b * L + i) * D + d] = acc;
    }
    __syncthreads();

    // Logits.
    gemv_partials<WT, kRows>(hc, HD, HD, static_cast<const WT*>(a.w_out), V, part);
    __syncthreads();
    for (int k = tid; k < kRows * V; k += nt) {
      const int r = k / V, n = k % V, b = b0 + r;
      const float v = a.b_out[n] + gemv_sum<WT, kRows>(part, V, r, n);
      lg[r * V + n] = v;
      if (b < B) a.logits[((size_t)b * L + i) * V + n] = v;
    }
    __syncthreads();

    // Argmax, the first maximum: one warp per row.
    for (int r = warp; r < kRows; r += nw) {
      float best = -INFINITY;
      int bi = 0;
      for (int n = lane; n < V; n += 32) {
        const float v = lg[r * V + n];
        if (v > best) best = v, bi = n;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > best || (ov == best && oi < bi)) best = ov, bi = oi;
      }
      if (lane == 0) pred_s[r] = bi;
    }
    __syncthreads();
  }
}

struct BwdArgs {
  const float* dlogits;    // [B,L,V]
  const int* enc_len;      // [B]
  const void* enc;         // [B,T,D] WT
  const void* encp;        // [B,T,A] WT
  const void* woutT;       // [V][H+D] WT
  const void* attqT;       // [A][H] WT
  const void* wcatT;       // [4H][E+D+H] WT
  const float* att_v;      // [A] (add, loc)
  const float* loc_filt;   // [W][C], rounded to WT (loc)
  const float* loc_proj;   // [C][A], rounded to WT (loc)
  const float* c_seq;      // [B,L,H]
  const float* acts;       // [B,L,4H]
  const float* att_seq;    // [B,L,T]
  const float* q_seq;      // [B,L,A]
  float* dgates;           // [B,L,4H]
  float* dctx;             // [B,L,D]
  float* dqb;              // [B,L,A]
  float* demb;             // [B,L,E]
  float* dsn;              // [B,L,T] (dot)
  float* d_encp;           // [B,T,A]; add, loc: accumulated, zeroed by the caller
  float* dfct;             // [B,L,C*T] (loc; zeroed by the caller)
  float* dv_part;          // [B,A] (add, loc): row b's sum
  float* dlocp_part;       // [B,C,A] (loc): block sums in the first row's slot, zeroed by the caller
  int B, L, T, D, A, E, H, V, C, W;
  float scale;
};

// Shared-memory plan of the backward, in floats. The energy modes append
// v and the step's query, and loc loc_proj, the filter, the previous
// step's weights, the feature, its gradient, the carry and the block's
// d_loc_proj sum; their part also holds the tile of a chunk's tanh
// [kRows][kLocTile][A+4] and (loc) the carry's per-channel sums
// [kRows][C][T].
struct BwdSmem {
  size_t vin, kv, dctx_r, dh_tot, dh, dc, dctxc, sc, part, v, qb, locp, filt,
      attp, f, dfct, datt, dlocp, total;
  __host__ __device__ BwdSmem(int mode, int T, int D, int A, int E, int H,
                             int V, int C, int W, int cols) {
    kv = V;
    if ((size_t)A > kv) kv = A;
    if ((size_t)4 * H > kv) kv = 4 * H;
    size_t o = 0;
    vin = o; o += kRows * kv;            // the product's rounded input
    dctx_r = o; o += (size_t)kRows * D;  // dctx_total, rounded
    dh_tot = o; o += (size_t)kRows * H;
    dh = o; o += (size_t)kRows * H;      // carries
    dc = o; o += (size_t)kRows * H;
    dctxc = o; o += (size_t)kRows * D;
    sc = o; o += (size_t)kRows * T;      // datt, then dsn
    part = o;
    const int outs[] = {H + D, H, E + D + H, A};  // the products' widths
    size_t p = 0;
    for (int n : outs)
      if (part_floats(n, cols) > p) p = part_floats(n, cols);
    if (mode != kDot) {
      const size_t tile = (size_t)kRows * kLocTile * (A + 4);
      const size_t carry = mode == kLoc ? (size_t)kRows * C * T : 0;
      if (tile > p) p = tile;
      if (carry > p) p = carry;
      part = o = align4(o);  // the tile takes 16-byte stores
    }
    o = align4(o + p);  // the energy modes' regions start 16-byte aligned
    const bool loc = mode == kLoc;
    v = o; o = align4(o + (mode == kDot ? 0 : (size_t)A));
    qb = o; o = align4(o + (mode == kDot ? 0 : (size_t)kRows * A));
    locp = o; o = align4(o + (loc ? (size_t)C * A : 0));
    filt = o; o = align4(o + (loc ? (size_t)W * C : 0));
    attp = o; o = align4(o + (loc ? (size_t)kRows * T : 0));
    f = o; o = align4(o + (loc ? (size_t)kRows * C * T : 0));
    dfct = o; o = align4(o + (loc ? (size_t)kRows * C * T : 0));
    datt = o; o = align4(o + (loc ? (size_t)kRows * T : 0));
    dlocp = o; o += loc ? (size_t)C * A : 0;
    total = o;
  }
};

// The energies of step i again and their gradient (pallas_decoder.py:
// 566-610) for the NR rows of a block from b0 on, ds in sc [NR][T], the
// query with its bias in qb_s [NR][A], and (loc) the feature in f_s: over
// chunks of TILE frames up to nmax, the block's longest row, a group of
// kELanes lanes per (row, frame), each lane along the frame's columns 4 at
// a time, forms th and de, updates d_enc_proj in place (the block owns its
// rows: no atomics) and (loc) sums its part of dfct, added up over the
// group's lanes. th goes to a tile in part [NR][TILE][A+4] for the sums
// over the chunk's frames that follow: thread (er, ea) of own adds row
// er's column ea of dqb to dq and of d_att_v to dv_acc; loc leaves the
// rounded energy gradient in th's place for d_loc_proj (dl_s), a product
// of the rounded feature with that tile, two channels and one column a
// thread. Ends with a barrier.
template <typename WT, bool LOC, int NR, int TILE>
__device__ void energy_bwd(const BwdArgs& a, int i, int b0, const int* len_s,
                           int nmax, const float* sc, const float* qb_s,
                           const float* v_s, const float* locp_s,
                           const float* f_s, float* part, float* dfct_s,
                           float* dl_s, bool own, int er, int ea,
                           float& dv_acc, float& dq) {
  static_assert(NR * TILE * kELanes == kThreads,
                "one energy group per (row, frame) of a chunk");
  const int B = a.B, L = a.L, T = a.T, A = a.A, C = a.C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const WT* encp = static_cast<const WT*>(a.encp);
  const int n_own = own ? len_s[er] : 0;
  const float vv = own ? v_s[ea] : 0.0f;
  const int grp = tid / kELanes, gl = tid % kELanes;
  const int gr = grp / TILE, gt = grp % TILE;
  const int TS = A + 4;  // the tile's row stride, 16-byte aligned
  for (int t0 = 0; t0 < nmax; t0 += TILE) {
    const int t1 = min(t0 + TILE, nmax);
    {
      const int t = t0 + gt, b = b0 + gr;
      const bool on = t < t1 && t < len_s[gr];
      const float dsv = on ? sc[gr * T + t] : 0.0f;
      const size_t row = ((size_t)b * T + t) * A;
      float dft[kMaxLocC];
#pragma unroll
      for (int c = 0; c < kMaxLocC; ++c) dft[c] = 0.0f;
      for (int n = 4 * gl; on && n < A; n += 4 * kELanes) {
        const float4 e = port::load4(encp + row + n);
        const float4 q = *reinterpret_cast<const float4*>(qb_s + gr * A + n);
        float x[4] = {e.x + q.x, e.y + q.y, e.z + q.z, e.w + q.w};
        if constexpr (LOC) {
          float fl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int c = 0; c < C; ++c) {
            const float fc = f_s[(gr * C + c) * T + t];
            const float4 l = *reinterpret_cast<const float4*>(locp_s + c * A + n);
            fl[0] = fmaf(fc, l.x, fl[0]);
            fl[1] = fmaf(fc, l.y, fl[1]);
            fl[2] = fmaf(fc, l.z, fl[2]);
            fl[3] = fmaf(fc, l.w, fl[3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] += fl[j];
        }
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + n);
        const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
        float th[4], de[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          th[j] = tanhf(x[j]);
          de[j] = (1.0f - th[j] * th[j]) * dsv * vj[j];
        }
        float4* dp = reinterpret_cast<float4*>(a.d_encp + row + n);
        float4 d = *dp;
        d.x += de[0], d.y += de[1], d.z += de[2], d.w += de[3];
        *dp = d;
        *reinterpret_cast<float4*>(part + (gr * TILE + gt) * TS + n) =
            make_float4(th[0], th[1], th[2], th[3]);
        if constexpr (LOC) {
          const float dr[4] = {rnd<WT>(de[0]), rnd<WT>(de[1]), rnd<WT>(de[2]),
                               rnd<WT>(de[3])};
#pragma unroll
          for (int c = 0; c < kMaxLocC; ++c) {
            if (c < C) {
              const float4 l = *reinterpret_cast<const float4*>(locp_s + c * A + n);
              dft[c] = fmaf(dr[0], l.x, fmaf(dr[1], l.y,
                            fmaf(dr[2], l.z, fmaf(dr[3], l.w, dft[c]))));
            }
          }
        }
      }
      if constexpr (LOC) {
        // dfct[r,c,t] = rounded de[r,t,:] . loc_proj[c,:] over the group.
#pragma unroll
        for (int c = 0; c < kMaxLocC; ++c) {
          if (c < C) {
            float sum = dft[c];
#pragma unroll
            for (int o = kELanes / 2; o > 0; o >>= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (on && gl == 0) {
              dfct_s[(gr * C + c) * T + t] = rnd<WT>(sum);
              if (b < B) a.dfct[(((size_t)b * L + i) * C + c) * T + t] = sum;
            }
          }
        }
      }
    }
    __syncthreads();
    if constexpr (NR == 1) K4B_PHASE(13);
    if (own) {
      int t = t0;
      if constexpr (NR == 1) {
        // Four frames a round, their loads issued before the round's
        // stores; the sums in the same order.
        for (; t + 4 <= min(t1, n_own); t += 4) {
          float* slot = part + (t - t0) * TS + ea;
          float th[4], dsv[4], de[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) th[j] = slot[j * TS], dsv[j] = sc[t + j];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            de[j] = (1.0f - th[j] * th[j]) * dsv[j] * vv;
            dv_acc = fmaf(th[j], dsv[j], dv_acc);
            dq += de[j];
          }
          if constexpr (LOC) {
#pragma unroll
            for (int j = 0; j < 4; ++j) slot[j * TS] = rnd<WT>(de[j]);
          }
        }
      }
      for (; t < min(t1, n_own); ++t) {
        float* slot = part + (er * TILE + t - t0) * TS + ea;
        const float th = *slot;
        const float dsv = sc[er * T + t];
        const float de = (1.0f - th * th) * dsv * vv;
        dv_acc = fmaf(th, dsv, dv_acc);
        dq += de;
        if constexpr (LOC) *slot = rnd<WT>(de);
      }
    }
    if constexpr (LOC) {
      __syncthreads();
      if constexpr (NR == 1) K4B_PHASE(14);
      for (int it = tid; it < (C + 1) / 2 * A; it += nt) {
        const int c = 2 * (it / A), n = it % A;
        const bool two = c + 1 < C;
        float acc0 = 0.0f, acc1 = 0.0f;
        for (int r = 0; r < NR; ++r) {
          const float* f0 = f_s + (r * C + c) * T;
          const float* f1 = two ? f0 + T : f0;
          const float* col = part + r * TILE * TS + n;
          int t = t0;
          if constexpr (NR == 1) {
            // Four frames a round; the feature's words as one 16-byte read
            // each where the rows are 16-byte aligned.
            for (; t + 4 <= min(t1, len_s[r]); t += 4) {
              float de[4], x0[4], x1[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) de[j] = col[(t + j - t0) * TS];
              if (T % 4 == 0) {
                const float4 y0 = *reinterpret_cast<const float4*>(f0 + t);
                const float4 y1 = *reinterpret_cast<const float4*>(f1 + t);
                x0[0] = y0.x, x0[1] = y0.y, x0[2] = y0.z, x0[3] = y0.w;
                x1[0] = y1.x, x1[1] = y1.y, x1[2] = y1.z, x1[3] = y1.w;
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) x0[j] = f0[t + j], x1[j] = f1[t + j];
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc0 = fmaf(x0[j], de[j], acc0);
                acc1 = fmaf(x1[j], de[j], acc1);
              }
            }
          }
          for (; t < min(t1, len_s[r]); ++t) {
            const float de = col[(t - t0) * TS];
            acc0 = fmaf(f0[t], de, acc0);
            acc1 = fmaf(f1[t], de, acc1);
          }
        }
        dl_s[c * A + n] += acc0;
        if (two) dl_s[(c + 1) * A + n] += acc1;
      }
    }
    __syncthreads();
    if constexpr (NR == 1) K4B_PHASE(15);
  }
}

template <typename WT, int MODE>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int len_s[kRows];
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V, C = a.C, W = a.W;
  const int HD = H + D, H4 = 4 * H, KX = E + D + H;
  const BwdSmem plan(MODE, T, D, A, E, H, V, C, W, Pack<WT>::kN);
  const int KV = (int)plan.kv;
  float* vin = sm + plan.vin;
  float* dctx_r = sm + plan.dctx_r;
  float* dh_tot = sm + plan.dh_tot;
  float* dh = sm + plan.dh;
  float* dc = sm + plan.dc;
  float* dctxc = sm + plan.dctxc;
  float* sc = sm + plan.sc;
  float* part = sm + plan.part;
  float* v_s = sm + plan.v;
  float* qb_s = sm + plan.qb;
  float* locp_s = sm + plan.locp;
  float* filt_s = sm + plan.filt;
  float* attp = sm + plan.attp;
  float* f_s = sm + plan.f;
  float* dfct_s = sm + plan.dfct;
  float* datt_c = sm + plan.datt;
  float* dl_s = sm + plan.dlocp;
  const WT* enc = static_cast<const WT*>(a.enc);
  const WT* encp = static_cast<const WT*>(a.encp);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int b0 = blockIdx.x * kRows;
  // The energy modes: this thread's (row, attention column) of the sums
  // over frames, and its sum over every step of d_att_v.
  const bool own = MODE != kDot && tid < kRows * A;
  const int er = own ? tid / A : 0, ea = own ? tid % A : 0, eb = b0 + er;
  float dv_acc = 0.0f;

  for (int k = tid; k < (int)plan.part; k += nt) sm[k] = 0.0f;
  if constexpr (MODE != kDot) {
    for (int k = tid; k < A; k += nt) v_s[k] = a.att_v[k];
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; k < C * A; k += nt) locp_s[k] = a.loc_proj[k];
    for (int k = tid; k < W * C; k += nt) filt_s[k] = a.loc_filt[k];
    for (int k = tid; k < kRows * T; k += nt) datt_c[k] = 0.0f;
    for (int k = tid; k < C * A; k += nt) dl_s[k] = 0.0f;
  }
  if (tid < kRows) len_s[tid] = b0 + tid < B ? min(max(a.enc_len[b0 + tid], 0), T) : 0;
  __syncthreads();
  int nmax = 0;  // the block's longest row
  for (int r = 0; r < kRows; ++r) nmax = max(nmax, len_s[r]);

  for (int i = L - 1; i >= 0; --i) {
    // Output head: d[h; ctx] = dlogits . W_out^T.
    for (int k = tid; k < kRows * V; k += nt) {
      const int r = k / V, n = k % V, b = b0 + r;
      vin[r * KV + n] = b < B ? rnd<WT>(a.dlogits[((size_t)b * L + i) * V + n]) : 0.0f;
    }
    __syncthreads();
    gemv_partials<WT, kRows>(vin, KV, V, static_cast<const WT*>(a.woutT), HD, part);
    __syncthreads();
    for (int k = tid; k < kRows * HD; k += nt) {
      const int r = k / HD, n = k % HD, b = b0 + r;
      const float v = gemv_sum<WT, kRows>(part, HD, r, n);
      if (n < H) {
        dh_tot[r * H + n] = dh[r * H + n] + v;
      } else {
        const int d = n - H;
        const float x = dctxc[r * D + d] + v;
        dctx_r[r * D + d] = rnd<WT>(x);
        if (b < B) a.dctx[((size_t)b * L + i) * D + d] = x;
      }
    }
    __syncthreads();

    // Context -> attention weights.
    frame_dots(enc + (size_t)b0 * T * D, (size_t)T * D, D, dctx_r, D, len_s, T,
               1.0f, sc);
    __syncthreads();

    // Softmax backward (alpha is 0 past the row's length): one warp a row.
    // Dot mode scales the score gradient by 1/sqrt(A); loc first adds the
    // carry from step i+1 (the gradient of these weights through its
    // location feature).
    const float sscale = MODE == kDot ? a.scale : 1.0f;
    for (int r = warp; r < kRows; r += nw) {
      const int n = len_s[r], b = b0 + r;
      if (b >= B) continue;
      const float* al = a.att_seq + ((size_t)b * L + i) * T;
      if constexpr (MODE == kLoc) {
        for (int t = lane; t < n; t += 32) sc[r * T + t] = datt_c[r * T + t] + sc[r * T + t];
      }
      float tot = 0.0f;
      for (int t = lane; t < n; t += 32) tot = fmaf(sc[r * T + t], al[t], tot);
      tot = warp_sum(tot);
      for (int t = lane; t < T; t += 32) {
        const float v = t < n ? al[t] * (sc[r * T + t] - tot) * sscale : 0.0f;
        sc[r * T + t] = v;
        if constexpr (MODE == kDot) a.dsn[((size_t)b * L + i) * T + t] = v;
      }
    }
    __syncthreads();

    if constexpr (MODE == kDot) {
      // dqb[r] = dsn[r] . enc_proj[r] (dsn in f32, as the TPU kernel).
      gemv_rows(sc, T, len_s, encp + (size_t)b0 * T * A, (size_t)T * A, A, part);
      __syncthreads();
      for (int k = tid; k < kRows * A; k += nt) {
        const int r = k / A, n = k % A, b = b0 + r;
        const float acc = gemv_row_sum<WT>(part, A, r, n);
        vin[r * KV + n] = rnd<WT>(acc);
        if (b < B) a.dqb[((size_t)b * L + i) * A + n] = acc;
      }
    } else {
      // The energies again and their gradient (pallas_decoder.py:566-610),
      // ds in sc. Loc first recomputes the feature from step i-1's weights.
      constexpr bool LOC = MODE == kLoc;
      if constexpr (LOC) {
        for (int k = tid; k < kRows * T; k += nt) {
          const int r = k / T, t = k % T, b = b0 + r;
          attp[k] = i > 0 && b < B
              ? rnd<WT>(a.att_seq[((size_t)b * L + i - 1) * T + t]) : 0.0f;
        }
        __syncthreads();
        loc_feature<WT>(attp, filt_s, C, W, len_s, T, f_s);
        __syncthreads();
      }
      // The step's query (with its bias), for the frame-major phase.
      for (int k = tid; k < kRows * A; k += nt) {
        const int b = b0 + k / A;
        qb_s[k] = b < B ? a.q_seq[((size_t)b * L + i) * A + k % A] : 0.0f;
      }
      __syncthreads();
      float dq = 0.0f;
      energy_bwd<WT, LOC, kRows, kLocTile>(a, i, b0, len_s, nmax, sc, qb_s,
                                           v_s, locp_s, f_s, part, dfct_s,
                                           dl_s, own, er, ea, dv_acc, dq);
      if constexpr (LOC) {
        // The carry into step i-1: dfct . band^T.
        loc_carry<WT>(dfct_s, filt_s, C, W, len_s, T, part, datt_c);
      }
      if (own) {
        vin[er * KV + ea] = rnd<WT>(dq);
        if (eb < B) a.dqb[((size_t)eb * L + i) * A + ea] = dq;
      }
    }
    __syncthreads();

    // The query's gradient into h: dqb . att_q^T.
    gemv_partials<WT, kRows>(vin, KV, A, static_cast<const WT*>(a.attqT), H, part);
    __syncthreads();

    // The cell, from the activations K4-fwd saved.
    for (int k = tid; k < kRows * H; k += nt) {
      const int r = k / H, u = k % H, b = b0 + r;
      float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < B) {
        const size_t at = (size_t)b * L + i;
        const float dht = dh_tot[r * H + u] + gemv_sum<WT, kRows>(part, H, r, u);
        const float* ac = a.acts + at * H4;
        const float si = ac[u], sf = ac[H + u], tg = ac[2 * H + u], so = ac[3 * H + u];
        const float ct = a.c_seq[at * H + u];
        const float cp = i > 0 ? a.c_seq[(at - 1) * H + u] : 0.0f;
        const float tc = tanhf(ct);
        const float d_o = dht * tc;
        const float dct = dht * so * (1.0f - tc * tc) + dc[r * H + u];
        g[0] = dct * tg * si * (1.0f - si);
        g[1] = dct * cp * sf * (1.0f - sf);
        g[2] = dct * si * (1.0f - tg * tg);
        g[3] = d_o * so * (1.0f - so);
        dc[r * H + u] = dct * sf;
        float* out = a.dgates + at * H4;
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j * H + u] = g[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) vin[r * KV + j * H + u] = rnd<WT>(g[j]);
    }
    __syncthreads();

    // dgates . [W_x; W_h]^T -> demb, the context carry, the h carry.
    gemv_partials<WT, kRows>(vin, KV, H4, static_cast<const WT*>(a.wcatT), KX, part);
    __syncthreads();
    for (int k = tid; k < kRows * KX; k += nt) {
      const int r = k / KX, n = k % KX, b = b0 + r;
      const float v = gemv_sum<WT, kRows>(part, KX, r, n);
      if (n < E) {
        if (b < B) a.demb[((size_t)b * L + i) * E + n] = v;
      } else if (n < E + D) {
        dctxc[r * D + n - E] = v;
      } else {
        dh[r * H + n - E - D] = v;
      }
    }
    __syncthreads();
  }
  if constexpr (MODE != kDot) {
    if (own && eb < B) a.dv_part[(size_t)eb * A + ea] = dv_acc;
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; b0 < B && k < C * A; k += nt)
      a.dlocp_part[(size_t)b0 * C * A + k] = dl_s[k];
  }
}

// ---------------------------------------------------------------------------
// bwd_cluster_kernel: one batch row a CTA, the products split by columns
// across a cluster of kCl CTAs (see the header)
// ---------------------------------------------------------------------------

constexpr int kCl = 8;          // CTAs of a cluster: the cluster's batch rows
constexpr int kWarpGroups = 16; // column groups of a product's warp
constexpr int kClTile = 64;     // frames of an energy chunk at one row a CTA
static_assert(kCl == 8, "a product lane keeps one half of the rows, 4 of 8");

// Columns of X (H, D or E) that one CTA owns: a multiple of 4 (one
// product item's group); kCl of them cover X, the last ones padded.
__host__ __device__ inline int cl_units(int X) {
  return 4 * ((X + 4 * kCl - 1) / (4 * kCl));
}

// Depth splits of a product of G column groups over K: as many as the
// block's warps hold beside the ceil(G / kWarpGroups) warp columns, at
// most one a 32 of depth (each output then sums at most K / 32 partials).
__host__ __device__ inline int cl_splits(int G, int K) {
  const int s = kThreads / 32 / ((G + kWarpGroups - 1) / kWarpGroups);
  const int cap = K / 32;
  return s < cap ? (s < 1 ? 1 : s) : (cap < 1 ? 1 : cap);
}

// Four adjacent weights of a slice: one 16-byte (f32) or 8-byte (bf16)
// load, kept raw until its products.
template <typename WT>
struct Quad;

template <>
struct Quad<float> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 get(const Raw& q) { return q; }
};

template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static float4 get(const Raw& q) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// The stride of a product input's halves in shared memory, in 16-byte
// quads: K rounded up to 4 more than a multiple of 8, so that the two
// halves' words of the same depth lie in different banks.
__host__ __device__ inline int cl_stride(int K) { return K + (12 - K % 8) % 8; }

// acc[r][c] += v[4h + r][k] * w[c] for the four rows of half h; vh is
// v's half h (cl_product).
__device__ __forceinline__ void cl_fma(const float* vh, int k, const float4& w,
                                       float (&acc)[4][4]) {
  const float4 x4 = *reinterpret_cast<const float4*>(vh + (size_t)k * 4);
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r][0] = fmaf(x[r], w.x, acc[r][0]);
    acc[r][1] = fmaf(x[r], w.y, acc[r][1]);
    acc[r][2] = fmaf(x[r], w.z, acc[r][2]);
    acc[r][3] = fmaf(x[r], w.w, acc[r][3]);
  }
}

// One product of the cluster kernels: for the kCl rows r of the cluster
// and this CTA's N = 4G columns n, part[(s * kCl + r) * N + n] = the sum
// over split s of the depth K of v[r][k] * W[k][n]. v: [2][ks][4] in
// shared memory, rows 4h .. 4h+3 of depth k at (h * ks + k) * 4, ks =
// cl_stride(K) unless given (the forward's query reads the h part of the
// gate input, whose half stride is the gate product's);
// W: this CTA's slice as [K][G][4], the 4 columns of group g at depth k at
// (k * G + g) * 4 (ops/las_decoder.py::_cluster_slices). A warp takes
// 16 groups (a warp column) and one split s of the depth, lane 2j + h
// group j of them and rows 4h .. 4h+3, all lanes on the same depth at
// once: a load of W is one run of 128 bytes (bf16; 256 in f32) that the
// two halves share, and a read of v two 16-byte words every lane of a half
// shares (a broadcast). Each lane keeps acc[4][4] (16 registers: 1024
// threads leave 64 a thread), 64 bytes of weights in flight before their
// products, and stores its four rows' partial sums. Every sum runs in a
// fixed order. Ends without a barrier.
template <typename WT>
__device__ void cl_product(const float* v, int K, const WT* __restrict__ W,
                           int G, int S, float* part, int ks = 0) {
  using Q = Quad<WT>;
  constexpr int U = 16 / sizeof(WT);  // loads in flight: 64 bytes a lane
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int WC = (G + kWarpGroups - 1) / kWarpGroups;  // warp columns
  const int wc = warp % WC, s = warp / WC;
  const int g = wc * kWarpGroups + lane / 2, h = lane % 2;
  if (s >= S || g >= G) return;
  const int kc = (K + S - 1) / S, N = 4 * G;
  const int k1 = min(K, (s + 1) * kc);
  const float* vh = v + (size_t)h * (ks > 0 ? ks : cl_stride(K)) * 4;
  const WT* w = W + (size_t)g * 4;
  const size_t ld = (size_t)G * 4;  // W's row stride
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  int k = s * kc;
  for (; k + U <= k1; k += U) {
    typename Q::Raw q[U];
#pragma unroll
    for (int j = 0; j < U; ++j) q[j] = Q::load(w + (k + j) * ld);
#pragma unroll
    for (int j = 0; j < U; ++j) cl_fma(vh, k + j, Q::get(q[j]), acc);
  }
  for (; k < k1; ++k) cl_fma(vh, k, Q::get(Q::load(w + k * ld)), acc);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(part + ((size_t)s * kCl + 4 * h + r) * N + 4 * g) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The finished sum of output (r, n) of cl_product, in the order of the
// splits.
__device__ __forceinline__ float cl_sum(const float* part, int S, int N,
                                        int r, int n) {
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[((size_t)s * kCl + r) * N + n];
  return acc;
}

// Shared-memory plan of the cluster kernel, in floats. The receive slots
// of the three exchanges (dctx_total of the row; dqb and dgates of the
// cluster's rows, [2][cl_stride(K)][4] as cl_product reads them), the
// head's input, the carries and the cell's inputs of this CTA's columns,
// the row's score gradient, then part (the products' split sums, dot's
// dqb partials, the energy modes' tile [kClTile][A+4], loc's padded dfct
// and carry sums, loc_carry_row) and the energy modes' regions as
// BwdSmem's at one row, the weights' with zeros around them
// (loc_feature_row).
struct ClBwdSmem {
  size_t al, vh, slot2, slot3, slot1, dh_tot, dh, dc, dctxc, cell, sc, part,
      v, qb, locp, filt, attp, f, dfct, datt, dlocp, total;
  __host__ __device__ ClBwdSmem(int mode, int T, int D, int A, int E, int H,
                               int V, int C, int W, int cols) {
    const int HU = cl_units(H), DU = cl_units(D), EU = cl_units(E);
    const int NH = HU + DU, NX = EU + DU + HU;
    size_t o = 0;
    al = o; o = align4(o + T);                      // the row's weights
    vh = o; o += (size_t)8 * cl_stride(V);          // rounded dlogits
    slot2 = o; o += (size_t)8 * cl_stride(A);       // rounded dqb
    slot3 = o; o += (size_t)8 * cl_stride(4 * H);   // rounded dgates
    slot1 = o; o = align4(o + D);    // [D]: the row's rounded dctx_total
    dh_tot = o; o += (size_t)kCl * HU;
    dh = o; o += (size_t)kCl * HU;
    dc = o; o += (size_t)kCl * HU;
    dctxc = o; o += (size_t)kCl * DU;
    cell = o; o += (size_t)6 * kCl * HU;  // [kCl][6][HU]: acts, c, c_prev
    sc = o; o = align4(o + T);
    part = o;
    size_t p = 0;
    const int prods[3][2] = {{NH / 4, V}, {HU / 4, A}, {NX / 4, 4 * H}};
    for (const auto& g : prods) {
      const size_t n = (size_t)cl_splits(g[0], g[1]) * kCl * 4 * g[0];
      if (n > p) p = n;
    }
    if (mode == kDot) {
      const size_t n = (size_t)gemv_splits(A, kThreads, cols) * A;
      if (n > p) p = n;
    } else {
      const size_t tile = (size_t)kClTile * (A + 4);
      const size_t carry = mode == kLoc ? (size_t)C * (2 * T + 2 * W + 4) : 0;
      if (tile > p) p = tile;
      if (carry > p) p = carry;
    }
    o = align4(o + p);
    const bool loc = mode == kLoc;
    v = o; o = align4(o + (mode == kDot ? 0 : (size_t)A));
    qb = o; o = align4(o + (mode == kDot ? 0 : (size_t)A));
    locp = o; o = align4(o + (loc ? (size_t)C * A : 0));
    filt = o; o = align4(o + (loc ? (size_t)W * C : 0));
    attp = o; o = align4(o + (loc ? (size_t)T + W + 3 : 0));
    f = o; o = align4(o + (loc ? (size_t)C * T : 0));
    dfct = o; o = align4(o + (loc ? (size_t)C * T : 0));
    datt = o; o = align4(o + (loc ? (size_t)T : 0));
    dlocp = o; o += loc ? (size_t)C * A : 0;
    total = o;
  }
};

// Grid kCl * ceil(B / kCl) blocks, clusters of kCl along x: cluster c owns
// rows [kCl * c, +kCl), CTA r of it (its rank) row kCl * c + r. w_head,
// w_query, w_gates: the kCl per-CTA slices of W_out^T, att_q^T and
// [W_x; W_h]^T (_cluster_slices): CTA r's slice of a product with N_r
// columns is [K][N_r] at r * N_r * K. Every CTA runs every step
// and reaches every cluster barrier, whatever its row: past B or without
// frames it computes its columns of the products for the others.
template <typename WT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
bwd_cluster_kernel(BwdArgs a, const WT* __restrict__ w_head,
                   const WT* __restrict__ w_query,
                   const WT* __restrict__ w_gates) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int len_s[1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V, C = a.C, W = a.W;
  const int H4 = 4 * H;
  const int HU = cl_units(H), DU = cl_units(D), EU = cl_units(E);
  const int NH = HU + DU, NX = EU + DU + HU;
  const ClBwdSmem plan(MODE, T, D, A, E, H, V, C, W, Pack<WT>::kN);
  float* al_s = sm + plan.al;
  float* vh = sm + plan.vh;
  float* slot1 = sm + plan.slot1;
  float* slot2 = sm + plan.slot2;
  float* slot3 = sm + plan.slot3;
  float* dh_tot = sm + plan.dh_tot;
  float* dh = sm + plan.dh;
  float* dc = sm + plan.dc;
  float* dctxc = sm + plan.dctxc;
  float* cell = sm + plan.cell;
  float* sc = sm + plan.sc;
  float* part = sm + plan.part;
  float* v_s = sm + plan.v;
  float* qb_s = sm + plan.qb;
  float* locp_s = sm + plan.locp;
  float* filt_s = sm + plan.filt;
  float* attp = sm + plan.attp;
  float* f_s = sm + plan.f;
  float* dfct_s = sm + plan.dfct;
  float* datt_c = sm + plan.datt;
  float* dl_s = sm + plan.dlocp;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x / kCl * kCl;  // the cluster's first row
  const int b = b0 + rank;                // this CTA's row
  const bool live = b < B;
  const size_t rowb = live ? b : 0;  // a row to point at past B (never read)
  const WT* enc = static_cast<const WT*>(a.enc) + rowb * T * D;
  const WT* encp = static_cast<const WT*>(a.encp) + rowb * T * A;
  const WT* wh = w_head + (size_t)rank * NH * V;
  const WT* wq = w_query + (size_t)rank * HU * A;
  const WT* wg = w_gates + (size_t)rank * NX * H4;
  const int Sh = cl_splits(NH / 4, V), Sq = cl_splits(HU / 4, A),
            Sg = cl_splits(NX / 4, H4);
  // the half strides of the three product inputs
  const int KV = cl_stride(V), KA = cl_stride(A), KG = cl_stride(H4);
  // The energy modes: this thread's attention column of the sums over
  // frames, and its sum over every step of d_att_v.
  const bool own = MODE != kDot && tid < A;
  float dv_acc = 0.0f;

  for (int k = tid; k < (int)plan.total; k += nt) sm[k] = 0.0f;
  __syncthreads();
  if constexpr (MODE != kDot) {
    for (int k = tid; k < A; k += nt) v_s[k] = a.att_v[k];
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; k < C * A; k += nt) locp_s[k] = a.loc_proj[k];
    for (int k = tid; k < W * C; k += nt) filt_s[k] = a.loc_filt[k];
  }
  if (tid == 0) len_s[0] = live ? min(max(a.enc_len[b], 0), T) : 0;
  // Every CTA of the cluster has started and cleared its slots before any
  // CTA stores into another's.
  cluster.sync();
  const int n = len_s[0];
#if K4B_TIMING
  if (tid == 0) {
    for (int p = 0; p < kPhases; ++p) k4b_acc_[p] = 0;
    k4b_t0_ = clock64();
  }
#endif

  for (int i = L - 1; i >= 0; --i) {
    // (a) The head's input for the cluster's rows, and the cell's saved
    // activations and c of this CTA's units (read now, used after two
    // exchanges).
    for (int k = tid; k < kCl * V; k += nt) {
      const int r = k / V, j = k % V, br = b0 + r;
      vh[((r >> 2) * KV + j) * 4 + (r & 3)] =
          br < B ? rnd<WT>(a.dlogits[((size_t)br * L + i) * V + j]) : 0.0f;
    }
    for (int k = tid; k < kCl * HU; k += nt) {
      const int r = k / HU, ul = k % HU, u = rank * HU + ul, br = b0 + r;
      float* ce = cell + (size_t)r * 6 * HU + ul;
      const bool on = br < B && u < H;
      const size_t at = (size_t)br * L + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) ce[j * HU] = on ? a.acts[at * H4 + j * H + u] : 0.0f;
      ce[4 * HU] = on ? a.c_seq[at * H + u] : 0.0f;
      ce[5 * HU] = on && i > 0 ? a.c_seq[(at - 1) * H + u] : 0.0f;
    }
    for (int t = tid; t < n; t += nt) al_s[t] = a.att_seq[((size_t)b * L + i) * T + t];
    __syncthreads();
    K4B_PHASE(0);

    // (b) The output head, d[h; ctx] = dlogits . W_out^T, this CTA's
    // units and context columns; each row's context columns go to the
    // row's CTA (exchange 1).
    cl_product<WT>(vh, V, wh, NH / 4, Sh, part);
    __syncthreads();
    K4B_PHASE(1);
    for (int k = tid; k < kCl * NH; k += nt) {
      const int r = k / NH, nl = k % NH, br = b0 + r;
      const float v = cl_sum(part, Sh, NH, r, nl);
      if (nl < HU) {
        dh_tot[r * HU + nl] = dh[r * HU + nl] + v;
      } else {
        const int dl = nl - HU, d = rank * DU + dl;
        if (d < D) {
          const float x = dctxc[r * DU + dl] + v;
          if (br < B) a.dctx[((size_t)br * L + i) * D + d] = x;
          *cluster.map_shared_rank(slot1 + d, r) = rnd<WT>(x);
        }
      }
    }
    port::cluster_arrive();
    port::cluster_wait();
    K4B_PHASE(2);

    // (c) The row's own phases: context -> attention weights, the softmax
    // backward (loc: the carry from step i+1 added first), and dqb.
    frame_dots_row<WT>(enc, D, slot1, n, T, sc);
    __syncthreads();
    K4B_PHASE(3);
    const float sscale = MODE == kDot ? a.scale : 1.0f;
    if (warp == 0 && live) {
      const float* al = al_s;
      if constexpr (MODE == kLoc) {
        for (int t = lane; t < n; t += 32) sc[t] = datt_c[t] + sc[t];
      }
      float tot = 0.0f;
      for (int t = lane; t < n; t += 32) tot = fmaf(sc[t], al[t], tot);
      tot = warp_sum(tot);
      for (int t = lane; t < T; t += 32) {
        const float v = t < n ? al[t] * (sc[t] - tot) * sscale : 0.0f;
        sc[t] = v;
        if constexpr (MODE == kDot) a.dsn[((size_t)b * L + i) * T + t] = v;
      }
    }
    __syncthreads();
    K4B_PHASE(4);
    // This row's dqb goes to its place in slot2, row `rank`.
    float* dq_row = slot2 + (size_t)(rank >> 2) * KA * 4 + (rank & 3);
    if constexpr (MODE == kDot) {
      // dqb = dsn . enc_proj (dsn in f32, as the TPU kernel).
      gemv_rows<WT, 1>(sc, T, len_s, encp, 0, A, part);
      __syncthreads();
      for (int k = tid; k < A; k += nt) {
        const float acc = gemv_row_sum<WT>(part, A, 0, k);
        dq_row[k * 4] = rnd<WT>(acc);
        if (live) a.dqb[((size_t)b * L + i) * A + k] = acc;
      }
    } else {
      constexpr bool LOC = MODE == kLoc;
      if constexpr (LOC) {
        // attp holds the weights at (W - 1) / 2 on, zeros around them.
        for (int t = tid; t < T; t += nt)
          attp[(W - 1) / 2 + t] = i > 0 && live
              ? rnd<WT>(a.att_seq[((size_t)b * L + i - 1) * T + t]) : 0.0f;
        __syncthreads();
        loc_feature_row<WT>(attp, filt_s, C, W, n, T, f_s);
      }
      for (int k = tid; k < A; k += nt)
        qb_s[k] = live ? a.q_seq[((size_t)b * L + i) * A + k] : 0.0f;
      __syncthreads();
      K4B_PHASE(12);
      float dq = 0.0f;
      energy_bwd<WT, LOC, 1, kClTile>(a, i, b, len_s, n, sc, qb_s, v_s,
                                      locp_s, f_s, part, dfct_s, dl_s, own,
                                      0, tid, dv_acc, dq);
      if constexpr (LOC) {
        // The carry into step i-1: dfct . band^T.
        loc_carry_row<WT>(dfct_s, filt_s, C, W, n, T, part, datt_c);
      }
      if (own) {
        dq_row[tid * 4] = rnd<WT>(dq);
        if (live) a.dqb[((size_t)b * L + i) * A + tid] = dq;
      }
    }
    __syncthreads();
    K4B_PHASE(5);
    // Exchange 2: the row's dqb to every other CTA.
    for (int k = tid; k < (kCl - 1) * A; k += nt) {
      const int dst = (rank + 1 + k / A) % kCl, j = k % A;
      *cluster.map_shared_rank(dq_row + j * 4, dst) = dq_row[j * 4];
    }
    port::cluster_arrive();
    port::cluster_wait();
    K4B_PHASE(6);

    // (d) The query's gradient into this CTA's units, dqb . att_q^T, and
    // their cells for the cluster's rows, four rows a thread so that a
    // gate's rounded gradient of the four is one 16-byte store in slot3.
    cl_product<WT>(slot2, A, wq, HU / 4, Sq, part);
    __syncthreads();
    K4B_PHASE(7);
    for (int k = tid; k < 2 * HU; k += nt) {
      const int hf = k / HU, ul = k % HU, u = rank * HU + ul;
      float gq[4][4];  // [gate][row 4hf + q]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * hf + q, br = b0 + r;
        float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (br < B && u < H) {
          const float dht = dh_tot[r * HU + ul] + cl_sum(part, Sq, HU, r, ul);
          const float* ce = cell + (size_t)r * 6 * HU + ul;
          const float si = ce[0], sf = ce[HU], tg = ce[2 * HU], so = ce[3 * HU];
          const float ct = ce[4 * HU], cp = ce[5 * HU];
          const float tc = tanhf(ct);
          const float d_o = dht * tc;
          const float dct = dht * so * (1.0f - tc * tc) + dc[r * HU + ul];
          g[0] = dct * tg * si * (1.0f - si);
          g[1] = dct * cp * sf * (1.0f - sf);
          g[2] = dct * si * (1.0f - tg * tg);
          g[3] = d_o * so * (1.0f - so);
          dc[r * HU + ul] = dct * sf;
          float* out = a.dgates + ((size_t)br * L + i) * H4;
#pragma unroll
          for (int j = 0; j < 4; ++j) out[j * H + u] = g[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) gq[j][q] = rnd<WT>(g[j]);
      }
      if (u < H) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(slot3 + ((size_t)hf * KG + j * H + u) * 4) =
              make_float4(gq[j][0], gq[j][1], gq[j][2], gq[j][3]);
      }
    }
    __syncthreads();
    K4B_PHASE(8);
    // Exchange 3: this CTA's units of every gate to every other CTA.
    const int mine = 8 * HU;  // (half, gate, unit) entries of 16 bytes
    for (int k = tid; k < (kCl - 1) * mine; k += nt) {
      const int dst = (rank + 1 + k / mine) % kCl, e = k % mine;
      const int hf = e / (4 * HU), j = e / HU % 4, u = rank * HU + e % HU;
      if (u < H) {
        float* at = slot3 + ((size_t)hf * KG + j * H + u) * 4;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(at, dst)) =
            *reinterpret_cast<const float4*>(at);
      }
    }
    port::cluster_arrive();
    port::cluster_wait();
    K4B_PHASE(9);

    // (e) dgates . [W_x; W_h]^T, this CTA's columns: demb, the context
    // carry and the h carry of its units.
    cl_product<WT>(slot3, H4, wg, NX / 4, Sg, part);
    __syncthreads();
    K4B_PHASE(10);
    for (int k = tid; k < kCl * NX; k += nt) {
      const int r = k / NX, nl = k % NX, br = b0 + r;
      const float v = cl_sum(part, Sg, NX, r, nl);
      if (nl < EU) {
        const int e = rank * EU + nl;
        if (e < E && br < B) a.demb[((size_t)br * L + i) * E + e] = v;
      } else if (nl < EU + DU) {
        dctxc[r * DU + nl - EU] = v;
      } else {
        dh[r * HU + nl - EU - DU] = v;
      }
    }
    __syncthreads();
    K4B_PHASE(11);
  }
  if constexpr (MODE != kDot) {
    if (own && live) a.dv_part[(size_t)b * A + tid] = dv_acc;
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; live && k < C * A; k += nt)
      a.dlocp_part[(size_t)b * C * A + k] = dl_s[k];
  }
#if K4B_TIMING
  if (tid == 0 && blockIdx.x == 0)
    for (int p = 0; p < kPhases; ++p) k4b_phase_cycles[p] += k4b_acc_[p];
#endif
  // No store into another CTA follows the last exchange; the barrier keeps
  // every CTA of the cluster resident until all have passed it.
  cluster.sync();
}

// Shared-memory plan of the forward's cluster kernel, in floats: the gate
// input of the cluster's rows by step parity (two [2][cl_stride(E+D+H)][4]
// buffers, [emb; ctx; h] rounded as cl_product reads it; the h part is
// also the query's input), the row's query (exchange 2's slot), c of this
// CTA's units for the 8 rows, the row's [h; ctx] rounded (the logits'
// input), its scores then weights, its logits, then part (the two
// products' split sums, the context's and the logits' partials at one
// row) and the energy modes' regions as FwdSmem's at one row, loc's
// previous weights with zeros around them (loc_feature_row).
struct ClFwdSmem {
  size_t gin, qs, cs, hc, sc, lg, part, v, locp, filt, attp, f, total;
  __host__ __device__ ClFwdSmem(int mode, int T, int D, int A, int E, int H,
                               int V, int C, int W, int cols) {
    const int HU = cl_units(H), AU = cl_units(A), KX = E + D + H;
    size_t o = 0;
    gin = o; o += (size_t)2 * 8 * cl_stride(KX);
    qs = o; o = align4(o + A);
    cs = o; o += (size_t)kCl * HU;
    hc = o; o = align4(o + H + D);
    sc = o; o = align4(o + T);
    lg = o; o = align4(o + V);
    part = o;
    size_t p = (size_t)cl_splits(HU, KX) * kCl * 4 * HU;
    const size_t pq = (size_t)cl_splits(AU / 4, H) * kCl * AU;
    if (pq > p) p = pq;
    const int rows[] = {D, V};  // the context and the logits, one row
    for (int n : rows) {
      const size_t pn = (size_t)gemv_splits(n, kThreads, cols) * n;
      if (pn > p) p = pn;
    }
    o = align4(o + p);
    const bool loc = mode == kLoc;
    v = o; o = align4(o + (mode == kDot ? 0 : (size_t)A));
    locp = o; o = align4(o + (loc ? (size_t)C * A : 0));
    filt = o; o = align4(o + (loc ? (size_t)W * C : 0));
    attp = o; o = align4(o + (loc ? (size_t)T + W + 3 : 0));
    f = o; o += loc ? (size_t)C * T : 0;
    total = o;
  }
};

// Grid kCl * ceil(B / kCl) blocks, clusters of kCl along x: cluster c owns
// rows [kCl * c, +kCl), CTA r of it (its rank) row kCl * c + r. w_gates,
// w_query: the kCl per-CTA slices of [W_x; W_h] and att_q by output column
// (_cluster_slices of their transposes): CTA r's slice of a product with
// N_r columns is [K][N_r] at r * N_r * K, the gates' N_r = 4 HU columns
// its units' i, f, g and o, the query's AU. W_out is read whole by each
// row's CTA. Every CTA runs every step and reaches every cluster barrier,
// whatever its row: past B or without frames it computes its columns of
// the products for the others.
template <typename WT, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
fwd_cluster_kernel(FwdArgs a, const WT* __restrict__ w_gates,
                   const WT* __restrict__ w_query) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int tok_s[kCl], len_s[1], next_s[1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V, C = a.C, W = a.W;
  const int KX = E + D + H, HD = H + D, H4 = 4 * H;
  const int HU = cl_units(H), AU = cl_units(A);
  const int KG = cl_stride(KX);  // the gate input's half stride
  const ClFwdSmem plan(MODE, T, D, A, E, H, V, C, W, Pack<WT>::kN);
  float* gin = sm + plan.gin;
  float* qs = sm + plan.qs;
  float* cs = sm + plan.cs;
  float* hc = sm + plan.hc;
  float* sc = sm + plan.sc;
  float* lg = sm + plan.lg;
  float* part = sm + plan.part;
  float* v_s = sm + plan.v;
  float* locp_s = sm + plan.locp;
  float* filt_s = sm + plan.filt;
  float* attp = sm + plan.attp;
  float* f_s = sm + plan.f;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x / kCl * kCl;  // the cluster's first row
  const int b = b0 + rank;                // this CTA's row
  const bool live = b < B;
  const size_t rowb = live ? b : 0;  // a row to point at past B (never read)
  const WT* enc = static_cast<const WT*>(a.enc) + rowb * T * D;
  const WT* encp = static_cast<const WT*>(a.encp) + rowb * T * A;
  const WT* embed = static_cast<const WT*>(a.embed);
  const WT* w_out = static_cast<const WT*>(a.w_out);
  const WT* wg = w_gates + (size_t)rank * 4 * HU * KX;
  const WT* wq = w_query + (size_t)rank * AU * H;
  const int Sg = cl_splits(HU, KX), Sq = cl_splits(AU / 4, H);
  const int pad = (W - 1) / 2;  // loc: the filter's frames before a frame

  for (int k = tid; k < (int)plan.total; k += nt) sm[k] = 0.0f;
  __syncthreads();
  if constexpr (MODE != kDot) {
    for (int k = tid; k < A; k += nt) v_s[k] = a.att_v[k];
  }
  if constexpr (MODE == kLoc) {
    for (int k = tid; k < C * A; k += nt) locp_s[k] = a.loc_proj[k];
    for (int k = tid; k < W * C; k += nt) filt_s[k] = a.loc_filt[k];
  }
  // Step 0's tokens of the cluster's rows (no argmax before it: 0, as
  // fwd_kernel's); the row's CTA writes its own.
  if (tid < kCl) {
    const int br = b0 + tid;
    int tok = 0;
    if (br < B) {
      const size_t at = (size_t)br * L;
      tok = a.coins[at] ? 0 : a.tokens[at];
      if (tid == rank) a.tok_seq[at] = tok;
    }
    tok_s[tid] = tok;
  }
  if (tid == 0) len_s[0] = live ? min(max(a.enc_len[b], 0), T) : 0;
  // Every CTA of the cluster has started and cleared its slots before any
  // CTA stores into another's.
  cluster.sync();
  const int n = len_s[0];
#if K4F_TIMING
  if (tid == 0) {
    for (int p = 0; p < kFwdPhases; ++p) k4f_acc_[p] = 0;
    k4f_t0_ = clock64();
  }
#endif

  for (int i = 0; i < L; ++i) {
    float* gcur = gin + (size_t)(i & 1) * 8 * KG;         // read this step
    float* gnext = gin + (size_t)((i + 1) & 1) * 8 * KG;  // filled for i+1
    // (a) The rows' embeddings into the gate input (ctx and h are there).
    for (int k = tid; k < kCl * E; k += nt) {
      const int r = k / E, e = k % E;
      gcur[((r >> 2) * KG + e) * 4 + (r & 3)] =
          b0 + r < B ? to_f(embed[(size_t)tok_s[r] * E + e]) : 0.0f;
    }
    __syncthreads();
    K4F_PHASE(0);

    // (b) The gates of this CTA's units for the cluster's rows, and their
    // cells; each unit's rounded h goes to every CTA (exchange 1).
    cl_product<WT>(gcur, KX, wg, HU, Sg, part);
    __syncthreads();
    K4F_PHASE(1);
    for (int k = tid; k < kCl * HU; k += nt) {
      const int r = k / HU, ul = k % HU, u = rank * HU + ul, br = b0 + r;
      if (u >= H) continue;
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        g[j] = a.b_x[j * H + u] + cl_sum(part, Sg, 4 * HU, r, j * HU + ul);
      const float si = port::sigmoid(g[0]);
      const float sf = port::sigmoid(g[1] + 1.0f);
      const float tg = tanhf(g[2]);
      const float so = port::sigmoid(g[3]);
      const float c = sf * cs[r * HU + ul] + si * tg;
      const float h = so * tanhf(c);
      cs[r * HU + ul] = c;
      gnext[((size_t)(r >> 2) * KG + E + D + u) * 4 + (r & 3)] = rnd<WT>(h);
      if (br < B) {
        const size_t at = (size_t)br * L + i;
        a.h_seq[at * H + u] = h;
        a.c_seq[at * H + u] = c;
        float* ac = a.acts + at * H4;
        ac[u] = si;
        ac[H + u] = sf;
        ac[2 * H + u] = tg;
        ac[3 * H + u] = so;
      }
    }
    __syncthreads();
    K4F_PHASE(2);
    // Exchange 1: the four rows of a half of each unit, one 16-byte store.
    for (int k = tid; k < (kCl - 1) * 2 * HU; k += nt) {
      const int dst = (rank + 1 + k / (2 * HU)) % kCl, e = k % (2 * HU);
      const int u = rank * HU + e % HU;
      if (u < H) {
        float* at = gnext + ((size_t)(e / HU) * KG + E + D + u) * 4;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(at, dst)) =
            *reinterpret_cast<const float4*>(at);
      }
    }
    port::cluster_arrive();
    port::cluster_wait();
    K4F_PHASE(3);

    // (c) The query's columns of this CTA for the cluster's rows, h from
    // the gate input; row r's go to CTA r (exchange 2).
    cl_product<WT>(gnext + (size_t)(E + D) * 4, H, wq, AU / 4, Sq, part, KG);
    __syncthreads();
    K4F_PHASE(4);
    for (int k = tid; k < kCl * AU; k += nt) {
      const int r = k / AU, al = k % AU, m = rank * AU + al, br = b0 + r;
      if (m >= A) continue;
      const float v = a.att_b[m] + cl_sum(part, Sq, AU, r, al);
      if (br < B) a.q_seq[((size_t)br * L + i) * A + m] = v;
      *cluster.map_shared_rank(qs + m, r) = v;
    }
    port::cluster_arrive();
    port::cluster_wait();
    K4F_PHASE(5);

    // (d) The row's own phases. Its rounded h, the logits' input.
    for (int k = tid; k < H; k += nt)
      hc[k] = gnext[((size_t)(rank >> 2) * KG + E + D + k) * 4 + (rank & 3)];
    if constexpr (MODE == kLoc) {
      // attp holds the previous step's weights, rounded (zeros at step 0).
      loc_feature_row<WT>(attp, filt_s, C, W, n, T, f_s);
    }
    __syncthreads();
    K4F_PHASE(6);
    if constexpr (MODE == kDot) {
      frame_dots_row<WT>(encp, A, qs, n, T, sc, a.scale);
    } else {
      frame_energies<WT, MODE == kLoc, 1>(encp, 0, A, qs, v_s, locp_s, f_s,
                                          C, len_s, T, sc);
    }
    __syncthreads();
    K4F_PHASE(7);
    // Masked softmax, one warp; exactly 0 past the row's length.
    if (warp == 0) {
      float m = kNeg;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[t]);
      m = warp_max(m);
      float z = 0.0f;
      for (int t = lane; t < n; t += 32) z += expf(sc[t] - m);
      z = warp_sum(z);
      for (int t = lane; t < T; t += 32) {
        const float w = t < n ? expf(sc[t] - m) / z : 0.0f;
        const float wr = rnd<WT>(w);  // the context's (and loc's) operand
        sc[t] = wr;
        if constexpr (MODE == kLoc) attp[pad + t] = wr;
        if (live) a.att_seq[((size_t)b * L + i) * T + t] = w;
      }
    }
    __syncthreads();
    K4F_PHASE(8);
    // Context: ctx = att . enc[b].
    gemv_rows<WT, 1>(sc, T, len_s, enc, 0, D, part);
    __syncthreads();
    for (int k = tid; k < D; k += nt) {
      const float acc = gemv_row_sum<WT>(part, D, 0, k);
      hc[H + k] = rnd<WT>(acc);
      if (live) a.ctx_seq[((size_t)b * L + i) * D + k] = acc;
    }
    __syncthreads();
    K4F_PHASE(9);
    // Logits.
    gemv_partials<WT, 1>(hc, 0, HD, w_out, V, part);
    __syncthreads();
    for (int k = tid; k < V; k += nt) {
      const float v = a.b_out[k] + gemv_sum<WT, 1>(part, V, 0, k);
      lg[k] = v;
      if (live) a.logits[((size_t)b * L + i) * V + k] = v;
    }
    __syncthreads();
    K4F_PHASE(10);
    // Argmax, the first maximum, and the next step's token.
    if (warp == 0) {
      float best = -INFINITY;
      int bi = 0;
      for (int m = lane; m < V; m += 32) {
        const float v = lg[m];
        if (v > best) best = v, bi = m;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > best || (ov == best && oi < bi)) best = ov, bi = oi;
      }
      if (lane == 0) {
        int tok = 0;
        if (live && i + 1 < L) {
          const size_t at = (size_t)b * L + i + 1;
          tok = a.coins[at] ? bi : a.tokens[at];
          a.tok_seq[at] = tok;
        }
        next_s[0] = tok;
      }
    }
    __syncthreads();
    K4F_PHASE(11);
    // Exchange 3: the row's rounded ctx into every CTA's gate input (its
    // own too), and its next token.
    float* ctx_at = gnext + ((size_t)(rank >> 2) * KG + E) * 4 + (rank & 3);
    for (int k = tid; k < kCl * D; k += nt) {
      const int dst = (rank + k / D) % kCl, d = k % D;
      *cluster.map_shared_rank(ctx_at + (size_t)d * 4, dst) = hc[H + d];
    }
    if (tid < kCl) *cluster.map_shared_rank(tok_s + rank, tid) = next_s[0];
    port::cluster_arrive();
    port::cluster_wait();
    K4F_PHASE(12);
  }
#if K4F_TIMING
  if (tid == 0 && blockIdx.x == 0)
    for (int p = 0; p < kFwdPhases; ++p) k4f_phase_cycles[p] += k4f_acc_[p];
#endif
  // No store into another CTA follows the last exchange; the barrier keeps
  // every CTA of the cluster resident until all have passed it.
  cluster.sync();
}

// d_enc_proj[b,t,:] = sum_i dsn[b,i,t] q[b,i,:]. Grid (ceil(T/kTT), B);
// a thread owns one column a (looping over A in blockDim steps) for kTT
// frames; dsn comes through shared memory in chunks of kLC steps.
constexpr int kTT = 16;
constexpr int kLC = 32;
constexpr int kEncpThreads = 128;

__global__ void __launch_bounds__(kEncpThreads)
d_encp_kernel(const float* __restrict__ dsn, const float* __restrict__ q,
              float* __restrict__ out, int L, int T, int A) {
  __shared__ float ds[kLC][kTT];
  const int b = blockIdx.y, t0 = blockIdx.x * kTT, tid = threadIdx.x;
  for (int a0 = 0; a0 < A; a0 += blockDim.x) {
    const int n = a0 + tid;
    float acc[kTT];
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[j] = 0.0f;
    for (int l0 = 0; l0 < L; l0 += kLC) {
      __syncthreads();
      for (int k = tid; k < kLC * kTT; k += blockDim.x) {
        const int li = k / kTT, tt = k % kTT, l = l0 + li, t = t0 + tt;
        ds[li][tt] = (l < L && t < T) ? dsn[((size_t)b * L + l) * T + t] : 0.0f;
      }
      __syncthreads();
      if (n < A) {
        const int lc = min(kLC, L - l0);
        for (int li = 0; li < lc; ++li) {
          const float qv = q[((size_t)b * L + l0 + li) * A + n];
#pragma unroll
          for (int j = 0; j < kTT; ++j) acc[j] = fmaf(ds[li][j], qv, acc[j]);
        }
      }
    }
    if (n < A) {
#pragma unroll
      for (int j = 0; j < kTT; ++j)
        if (t0 + j < T) out[((size_t)b * T + t0 + j) * A + n] = acc[j];
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The kernel of each direction for a shape, chosen by shape alone before
// any launch (ops/las_decoder.py::fwd_route and bwd_route mirror them):
// kRouteCluster, the cluster kernel, where its shared-memory plan fits;
// else 0, the two-rows kernel, where its plan fits; else -1, neither. The
// build variants K4F_CLUSTER 0 and K4B_CLUSTER 0 route every shape to the
// two-rows kernel.
constexpr int kRouteCluster = 1;

template <typename ClPlan, typename RowsPlan>
int route_by_plan(bool cluster, int mode, int cd_bf16, int T, int D, int A,
                  int E, int H, int V, int C, int W) {
  const int cols = cd_bf16 ? Pack<__nv_bfloat16>::kN : Pack<float>::kN;
  if (cluster &&
      sizeof(float) * ClPlan(mode, T, D, A, E, H, V, C, W, cols).total <= kMaxSmem)
    return kRouteCluster;
  if (sizeof(float) * RowsPlan(mode, T, D, A, E, H, V, C, W, cols).total <= kMaxSmem)
    return 0;
  return -1;
}

int fwd_route(int mode, int cd_bf16, int T, int D, int A, int E, int H, int V,
              int C, int W) {
  return route_by_plan<ClFwdSmem, FwdSmem>(K4F_CLUSTER, mode, cd_bf16, T, D,
                                           A, E, H, V, C, W);
}

int bwd_route(int mode, int cd_bf16, int T, int D, int A, int E, int H, int V,
              int C, int W) {
  return route_by_plan<ClBwdSmem, BwdSmem>(K4B_CLUSTER, mode, cd_bf16, T, D,
                                           A, E, H, V, C, W);
}

template <typename WT, int MODE>
cudaError_t launch_fwd_rows(const FwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * FwdSmem(MODE, a.T, a.D, a.A, a.E, a.H,
                                               a.V, a.C, a.W, Pack<WT>::kN).total;
  cudaError_t e = set_smem(fwd_kernel<WT, MODE>, bytes);
  if (e != cudaSuccess) return e;
  fwd_kernel<WT, MODE><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// A cluster kernel over ceil(B / kCl) clusters of kCl CTAs, with its
// arguments after `a`; kNoClusterFits without launching when the device
// holds none (cudaOccupancyMaxActiveClusters, asked once per kernel, plan
// size and process). The attribute is set on every call.
template <typename K, typename Args, typename... Ws>
int launch_cluster(K kernel, size_t bytes, const Args& a, cudaStream_t st,
                   size_t& known_bytes, int& known, Ws... ws) {
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(kCl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (known_bytes != bytes) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    known_bytes = bytes;
    known = n;
  }
  if (known < 1) return kNoClusterFits;
  cfg.gridDim = dim3(kCl * ((a.B + kCl - 1) / kCl));
  e = cudaLaunchKernelEx(&cfg, kernel, a, ws...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename WT, int MODE>
int launch_fwd_cluster(const FwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * ClFwdSmem(MODE, a.T, a.D, a.A, a.E,
                                                 a.H, a.V, a.C, a.W,
                                                 Pack<WT>::kN).total;
  static size_t known_bytes = 0;
  static int known = 0;
  return launch_cluster(fwd_cluster_kernel<WT, MODE>, bytes, a, st,
                        known_bytes, known, static_cast<const WT*>(a.wcat),
                        static_cast<const WT*>(a.att_q));
}

// `route`: the kernel whose weight layout the caller passed; it must be
// the one fwd_route picks for the shape (kRouteMismatch otherwise).
template <typename WT, int MODE>
int launch_fwd(const FwdArgs& a, int route, cudaStream_t st) {
  const int want = fwd_route(MODE, sizeof(WT) == 2, a.T, a.D, a.A, a.E, a.H,
                             a.V, a.C, a.W);
  if (want < 0) return (int)cudaErrorInvalidValue;
  if (route != want) return kRouteMismatch;
  return want == kRouteCluster ? launch_fwd_cluster<WT, MODE>(a, st)
                               : (int)launch_fwd_rows<WT, MODE>(a, st);
}

template <typename WT, int MODE>
cudaError_t launch_bwd_rows(const BwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * BwdSmem(MODE, a.T, a.D, a.A, a.E, a.H,
                                               a.V, a.C, a.W, Pack<WT>::kN).total;
  cudaError_t e = set_smem(bwd_kernel<WT, MODE>, bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<WT, MODE><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename WT, int MODE>
int launch_bwd_cluster(const BwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * ClBwdSmem(MODE, a.T, a.D, a.A, a.E,
                                                 a.H, a.V, a.C, a.W,
                                                 Pack<WT>::kN).total;
  static size_t known_bytes = 0;
  static int known = 0;
  return launch_cluster(bwd_cluster_kernel<WT, MODE>, bytes, a, st,
                        known_bytes, known, static_cast<const WT*>(a.woutT),
                        static_cast<const WT*>(a.attqT),
                        static_cast<const WT*>(a.wcatT));
}

// `route`: the kernel whose weight layout the caller passed; it must be
// the one bwd_route picks for the shape (kRouteMismatch otherwise).
template <typename WT, int MODE>
int launch_bwd(const BwdArgs& a, int route, cudaStream_t st) {
  const int want = bwd_route(MODE, sizeof(WT) == 2, a.T, a.D, a.A, a.E, a.H,
                             a.V, a.C, a.W);
  if (want < 0) return (int)cudaErrorInvalidValue;
  if (route != want) return kRouteMismatch;
  const int e = want == kRouteCluster ? launch_bwd_cluster<WT, MODE>(a, st)
                                      : (int)launch_bwd_rows<WT, MODE>(a, st);
  if (e != 0 || MODE != kDot) return e;
  const dim3 grid((a.T + kTT - 1) / kTT, a.B);
  d_encp_kernel<<<grid, kEncpThreads, 0, st>>>(a.dsn, a.q_seq, a.d_encp, a.L,
                                              a.T, a.A);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_fwd_mode(const FwdArgs& a, int mode, int route, cudaStream_t st) {
  switch (mode) {
    case kDot: return launch_fwd<WT, kDot>(a, route, st);
    case kAdd: return launch_fwd<WT, kAdd>(a, route, st);
    case kLoc: return launch_fwd<WT, kLoc>(a, route, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename WT>
int launch_bwd_mode(const BwdArgs& a, int mode, int route, cudaStream_t st) {
  switch (mode) {
    case kDot: return launch_bwd<WT, kDot>(a, route, st);
    case kAdd: return launch_bwd<WT, kAdd>(a, route, st);
    case kLoc: return launch_bwd<WT, kLoc>(a, route, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The shapes the kernels take: H <= 1024; the energy modes one thread per
// (row, attention column) of a block (A <= kThreads / kRows), the
// backward's energy lanes 4 columns at a time (A a multiple of 4); loc at
// most kMaxLocC channels.
bool dims_ok(int B, int L, int T, int D, int A, int E, int H, int V, int C,
             int W, int mode) {
  if (!(B > 0 && L > 0 && T > 0 && D > 0 && A > 0 && E > 0 && H > 0 &&
        H <= 1024 && V > 0))
    return false;
  if (mode == kDot) return true;
  if (mode != kAdd && mode != kLoc) return false;
  if (A > kThreads / kRows || A % 4 != 0) return false;
  return mode == kAdd || (C > 0 && C <= kMaxLocC && W > 0);
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers in the layouts
// of FwdArgs / BwdArgs above (NULL where the mode reads or writes none);
// the WT operands are float when cd_bf16 == 0 and __nv_bfloat16 when
// cd_bf16 == 1, 16-byte aligned. mode: 0 dot, 1 add, 2 loc. Each returns
// cudaGetLastError() after its launches (0 on success), or
// cudaErrorInvalidValue for a mode or shape the kernels cannot take (a
// block's shared memory grows with T, D, E, H, V and, loc, C and W).
//
// las_decoder_fwd's gate and query weights (wcat, att_q) are in the layout
// of `route` (las_decoder_fwd_route's answer for the shape): for
// fwd_kernel [W_x; W_h] [E+D+H][4H] and att_q [H][A]; for
// fwd_cluster_kernel the kCl per-CTA slices of their transposes
// (ops/las_decoder.py::_cluster_slices). Its other returns are
// las_decoder_bwd's.
extern "C" int las_decoder_fwd(
    const int* tokens, const uint8_t* coins, const int* enc_len,
    const void* enc, const void* encp, const void* embed, const void* wcat,
    const float* b_x, const void* att_q, const float* att_b,
    const float* att_v, const float* loc_filt, const float* loc_proj,
    const void* w_out, const float* b_out, float* logits, float* h_seq,
    float* c_seq, float* acts, float* q_seq, float* att_seq, float* ctx_seq,
    int* tok_seq, int B, int L, int T, int D, int A, int E, int H, int V,
    int C, int W, int mode, float scale, int cd_bf16, int route,
    void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V, C, W, mode)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{tokens, coins, enc_len, enc, encp, embed, wcat, b_x, att_q,
                  att_b, att_v, loc_filt, loc_proj, w_out, b_out, logits,
                  h_seq, c_seq, acts, q_seq, att_seq, ctx_seq, tok_seq,
                  B, L, T, D, A, E, H, V, C, W, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cd_bf16 ? launch_fwd_mode<__nv_bfloat16>(a, mode, route, st)
                 : launch_fwd_mode<float>(a, mode, route, st);
}

// las_decoder_bwd's three weight operands are in the layout of `route`
// (las_decoder_bwd_route's answer for the shape): for bwd_kernel W_out^T
// [V][H+D], att_q^T [A][H] and [W_x; W_h]^T [4H][E+D+H]; for
// bwd_cluster_kernel their kCl per-CTA slices (ops/las_decoder.py::
// _cluster_slices). It also returns kNoClusterFits (-1) without
// launching when no cluster of bwd_cluster_kernel fits on the device, and
// kRouteMismatch (-2) when `route` is not the shape's.
extern "C" int las_decoder_bwd(
    const float* dlogits, const int* enc_len, const void* enc,
    const void* encp, const void* woutT, const void* attqT, const void* wcatT,
    const float* att_v, const float* loc_filt, const float* loc_proj,
    const float* c_seq, const float* acts, const float* att_seq,
    const float* q_seq, float* dgates, float* dctx, float* dqb, float* demb,
    float* dsn, float* d_encp, float* dfct, float* dv_part,
    float* dlocp_part, int B, int L, int T, int D, int A, int E, int H,
    int V, int C, int W, int mode, float scale, int cd_bf16, int route,
    void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V, C, W, mode)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{dlogits, enc_len, enc, encp, woutT, attqT, wcatT, att_v,
                  loc_filt, loc_proj, c_seq, acts, att_seq, q_seq, dgates,
                  dctx, dqb, demb, dsn, d_encp, dfct, dv_part, dlocp_part,
                  B, L, T, D, A, E, H, V, C, W, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cd_bf16 ? launch_bwd_mode<__nv_bfloat16>(a, mode, route, st)
                 : launch_bwd_mode<float>(a, mode, route, st);
}

// The kernel las_decoder_fwd takes for a shape: 1 fwd_cluster_kernel, 0
// fwd_kernel, -1 none (the shape is refused).
extern "C" int las_decoder_fwd_route(int mode, int cd_bf16, int T, int D,
                                     int A, int E, int H, int V, int C, int W) {
  return fwd_route(mode, cd_bf16, T, D, A, E, H, V, C, W);
}

// The kernel las_decoder_bwd takes for a shape: 1 bwd_cluster_kernel, 0
// bwd_kernel, -1 none (the shape is refused).
extern "C" int las_decoder_bwd_route(int mode, int cd_bf16, int T, int D,
                                     int A, int E, int H, int V, int C, int W) {
  return bwd_route(mode, cd_bf16, T, D, A, E, H, V, C, W);
}

#if K4F_TIMING
// The forward's phase cycles counted since the last call (kFwdPhases of
// them), cleared.
extern "C" int las_decoder_fwd_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k4f_phase_cycles,
                                       sizeof(k4f_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kFwdPhases] = {};
  return (int)cudaMemcpyToSymbol(k4f_phase_cycles, zero, sizeof(zero));
}
#endif

#if K4B_TIMING
// The phase cycles counted since the last call (kPhases of them), cleared.
extern "C" int las_decoder_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k4b_phase_cycles,
                                       sizeof(k4b_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(k4b_phase_cycles, zero, sizeof(zero));
}
#endif

// The text of a return code of las_decoder_fwd (fwd != 0) or
// las_decoder_bwd (fwd == 0).
extern "C" const char* las_decoder_error_string(int code, int fwd) {
  if (code == kNoClusterFits) {
    return fwd ? "no cluster of 8 CTAs of fwd_cluster_kernel fits on this "
                 "device (cudaOccupancyMaxActiveClusters returned 0)"
               : "no cluster of 8 CTAs of bwd_cluster_kernel fits on this "
                 "device (cudaOccupancyMaxActiveClusters returned 0)";
  }
  if (code == kRouteMismatch) {
    return fwd ? "the weights were laid out for the other K4-fwd kernel than "
                 "the shape's (las_decoder_fwd_route)"
               : "the weights were laid out for the other K4-bwd kernel than "
                 "the shape's (las_decoder_bwd_route)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
