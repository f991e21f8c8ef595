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
// Design: one block of 1024 threads owns kRows whole batch rows for all L
// steps. Each step depends on the previous step's context, state and
// argmax (and, loc, attention weights), so no product can be hoisted out
// of the loop, and no block needs another block's rows: no grid-wide
// synchronisation. Each step is a few phases separated by __syncthreads:
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
//   - the backward's energies over chunks of kLocTile frames: kELanes
//     lanes per (row, frame) along its columns form tanh and de, update
//     d_enc_proj in place (the block owns its rows: no atomics) and sum
//     dfct over the group's lanes; the chunk's tanh goes through a tile in
//     shared memory to the sums over frames, dqb and d_att_v one (row,
//     column) a thread; loc puts the rounded energy gradient in its place
//     for d_loc_proj, two channels and one column a thread;
//   - the location feature as a convolution with the w x C filter in
//     shared memory (w*C*T multiply-adds a row, where the TPU kernel's
//     band product takes T*C*T and re-reads a T x C*T band every step),
//     and the backward's carry as the matching correlation;
//   - softmax and argmax (the first maximum, as jnp.argmax), one warp a row.
//
// What bounds it on the card: every step every block streams all the
// weights from L2 (W_x and W_h stacked: (E+D+H) x 4H = 1536 x 1280, 3.9 MB
// in bf16 at the flagship's width; att_q and W_out 0.26 MB) and its rows'
// enc and enc_proj (at T'=100 0.38 MB for 2 rows in bf16; at bench.py's
// T'=320 1.2 MB). The batch's enc and enc_proj are 18 MB at T'=100 and 59
// MB at T'=320, so at bench.py's shape they no longer fit the 50 MB L2 and
// part of each step's re-read comes from device memory: the first design
// pays for that re-read. The L steps of a row are sequential, so the time
// is L times one step's L2 stream per block, and that stream is bound by
// how many loads one SM keeps in flight, not by their bytes: on an H100
// the gate product takes about 40 us a step in bf16 and 50 in f32 (twice
// the bytes). The energy modes add T'*A tanh and (loc) about 3*C*T'*A
// multiply-adds a row and step on the CUDA cores, and the backward's
// d_enc_proj read-modify-write (4 bytes each way per energy). The design
// keeps the weight reads coalesced, 16 bytes a load, several loads issued
// before their products, S splits of the depth in flight per column group,
// and reuses each weight for kRows rows. Keeping the weights resident in
// shared memory across a thread-block cluster (each block a slice of the
// gate columns, h exchanged through distributed shared memory) and wgmma
// for the per-step products are the route to a faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

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
template <typename WT>
__device__ void gemv_rows(const float* v, int ldv, const int* len,
                          const WT* __restrict__ W, size_t row_stride, int N,
                          float* part) {
  const size_t per_row = (size_t)gemv_splits(N, blockDim.x, Pack<WT>::kN) * N;
  for (int r = 0; r < kRows; ++r)
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

// The energy scores of add and loc mode, with frame_dots' lane layout:
// out[r * T + t] = sum_a v[a] tanh(e[a]) for t < len[r], where
// e[a] = enc_proj[r,t,a] + qb[r * A + a] (+ sum_c f[(r*C + c)*T + t]
// locp[c * A + a] in loc mode, that sum formed first, as the TPU kernel
// adds the feature's product to the energy, pallas_decoder.py:259-271).
// qb, v, locp and f are in shared memory, v and locp 16-byte aligned; f
// and locp are rounded.
template <typename WT, bool LOC>
__device__ void frame_energies(const WT* __restrict__ rows, size_t row_stride,
                               int A, const float* qb, const float* v,
                               const float* locp, const float* f, int C,
                               const int* len, int T, float* out) {
  const int lane = threadIdx.x % 32, sl = lane % kDotLanes;
  const int per_warp = 32 / kDotLanes;
  const int first = threadIdx.x / 32 * per_warp + lane / kDotLanes;
  const int step = blockDim.x / 32 * per_warp;
  const int total = kRows * T;
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
      const int n_own = own ? len_s[er] : 0;
      const float vv = own ? v_s[ea] : 0.0f;
      float dq = 0.0f;
      // Frame-major over chunks of kLocTile frames: a group of kELanes
      // lanes per (row, frame), each lane along the frame's columns 4 at a
      // time, forms th and de, updates d_enc_proj in place and (loc) sums
      // its part of dfct, added up over the group's lanes. th goes to a
      // tile in part for the sums over the chunk's frames that follow.
      const int grp = tid / kELanes, gl = tid % kELanes;
      const int gr = grp / kLocTile, gt = grp % kLocTile;
      const int TS = A + 4;  // the tile's row stride, 16-byte aligned
      for (int t0 = 0; t0 < nmax; t0 += kLocTile) {
        const int t1 = min(t0 + kLocTile, nmax);
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
            *reinterpret_cast<float4*>(part + (gr * kLocTile + gt) * TS + n) =
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
        // Sums over the chunk's live frames from the th tile, one (row,
        // column) a thread: dqb and d_att_v; loc leaves the rounded energy
        // gradient in th's place for d_loc_proj, a product of the rounded
        // feature with that tile, two channels and one column a thread.
        if (own) {
          for (int t = t0; t < min(t1, n_own); ++t) {
            float* slot = part + (er * kLocTile + t - t0) * TS + ea;
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
          for (int it = tid; it < (C + 1) / 2 * A; it += nt) {
            const int c = 2 * (it / A), n = it % A;
            const bool two = c + 1 < C;
            float acc0 = 0.0f, acc1 = 0.0f;
            for (int r = 0; r < kRows; ++r) {
              const float* f0 = f_s + (r * C + c) * T;
              const float* f1 = two ? f0 + T : f0;
              const float* col = part + r * kLocTile * TS + n;
              for (int t = t0; t < min(t1, len_s[r]); ++t) {
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
      }
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

template <typename WT, int MODE>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * FwdSmem(MODE, a.T, a.D, a.A, a.E, a.H,
                                               a.V, a.C, a.W, Pack<WT>::kN).total;
  cudaError_t e = set_smem(fwd_kernel<WT, MODE>, bytes);
  if (e != cudaSuccess) return e;
  fwd_kernel<WT, MODE><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename WT, int MODE>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * BwdSmem(MODE, a.T, a.D, a.A, a.E, a.H,
                                               a.V, a.C, a.W, Pack<WT>::kN).total;
  cudaError_t e = set_smem(bwd_kernel<WT, MODE>, bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<WT, MODE><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || MODE != kDot) return e;
  const dim3 grid((a.T + kTT - 1) / kTT, a.B);
  d_encp_kernel<<<grid, kEncpThreads, 0, st>>>(a.dsn, a.q_seq, a.d_encp, a.L,
                                              a.T, a.A);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_fwd_mode(const FwdArgs& a, int mode, cudaStream_t st) {
  switch (mode) {
    case kDot: return launch_fwd<WT, kDot>(a, st);
    case kAdd: return launch_fwd<WT, kAdd>(a, st);
    case kLoc: return launch_fwd<WT, kLoc>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename WT>
cudaError_t launch_bwd_mode(const BwdArgs& a, int mode, cudaStream_t st) {
  switch (mode) {
    case kDot: return launch_bwd<WT, kDot>(a, st);
    case kAdd: return launch_bwd<WT, kAdd>(a, st);
    case kLoc: return launch_bwd<WT, kLoc>(a, st);
  }
  return cudaErrorInvalidValue;
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
extern "C" int las_decoder_fwd(
    const int* tokens, const uint8_t* coins, const int* enc_len,
    const void* enc, const void* encp, const void* embed, const void* wcat,
    const float* b_x, const void* att_q, const float* att_b,
    const float* att_v, const float* loc_filt, const float* loc_proj,
    const void* w_out, const float* b_out, float* logits, float* h_seq,
    float* c_seq, float* acts, float* q_seq, float* att_seq, float* ctx_seq,
    int* tok_seq, int B, int L, int T, int D, int A, int E, int H, int V,
    int C, int W, int mode, float scale, int cd_bf16, void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V, C, W, mode)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{tokens, coins, enc_len, enc, encp, embed, wcat, b_x, att_q,
                  att_b, att_v, loc_filt, loc_proj, w_out, b_out, logits,
                  h_seq, c_seq, acts, q_seq, att_seq, ctx_seq, tok_seq,
                  B, L, T, D, A, E, H, V, C, W, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cd_bf16 ? launch_fwd_mode<__nv_bfloat16>(a, mode, st)
                       : launch_fwd_mode<float>(a, mode, st));
}

extern "C" int las_decoder_bwd(
    const float* dlogits, const int* enc_len, const void* enc,
    const void* encp, const void* woutT, const void* attqT, const void* wcatT,
    const float* att_v, const float* loc_filt, const float* loc_proj,
    const float* c_seq, const float* acts, const float* att_seq,
    const float* q_seq, float* dgates, float* dctx, float* dqb, float* demb,
    float* dsn, float* d_encp, float* dfct, float* dv_part,
    float* dlocp_part, int B, int L, int T, int D, int A, int E, int H,
    int V, int C, int W, int mode, float scale, int cd_bf16, void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V, C, W, mode)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{dlogits, enc_len, enc, encp, woutT, attqT, wcatT, att_v,
                  loc_filt, loc_proj, c_seq, acts, att_seq, q_seq, dgates,
                  dctx, dqb, demb, dsn, d_encp, dfct, dv_part, dlocp_part,
                  B, L, T, D, A, E, H, V, C, W, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cd_bf16 ? launch_bwd_mode<__nv_bfloat16>(a, mode, st)
                       : launch_bwd_mode<float>(a, mode, st));
}

extern "C" const char* las_decoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
