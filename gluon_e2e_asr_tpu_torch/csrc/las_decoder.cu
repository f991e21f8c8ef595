// K4-fwd and K4-bwd: the teacher-forced LAS decoder over L steps, forward
// and backward, dot attention, for Hopper (sm_90a).
//
// Replace the TPU kernels gluon_e2e_asr_tpu/ops/pallas_decoder.py::
// las_decoder_fwd (pl.pallas_call at :434, body _fwd_kernel :161-304) and
// ::las_decoder_bwd (pl.pallas_call at :827, body _bwd_kernel :462-677),
// the forward and VJP of las_decoder_fused, for att_type "dot". Same math,
// gate order (i,f,g,o) with the forget bias +1 inside the cell. Every
// product takes operands rounded to the compute dtype WT (float or bf16)
// and sums in f32; state, softmax and gate math are f32. Per step i and
// batch row b:
//
//   tok   = coin[b,i] ? argmax(previous logits) : gold[b,i]
//   gates = [embed[tok]; ctx_prev; h_prev] . [W_x; W_h] + b_x
//   c, h  = cell(gates, c_prev)
//   q     = h . att_q + att_b
//   s[t]  = (enc_proj[b,t] . q) * scale   for t < len[b] (scale = 1/sqrt(A))
//   att   = softmax(s) over t < len[b], exactly 0 past it
//   ctx   = att . enc[b]
//   logits = [h; ctx] . W_out + b_out
//
// The forward writes logits and the residuals h, c, att, ctx, tok, plus
// what the backward reads instead of recomputing: the gate activations
// (sig(i), sig(f+1), tanh(g), sig(o)) and q. The backward sweeps i = L-1
// .. 0 with the TPU backward kernel's formulas (pallas_decoder.py:510-664)
// and writes the per-step streams dgates, dctx, dqb, demb and the scaled
// score gradient dsn [B,L,T]; then d_encp_kernel forms
// d_enc_proj[b] = sum_i dsn[b,i]^T q[b,i] (the TPU kernel's accumulation,
// :564). The weight gradients the TPU wrapper takes outside its kernel
// (:856-869) are the caller's.
//
// Design: one block of 1024 threads owns kRows whole batch rows for all L
// steps. Each step depends on the previous step's context, state and
// argmax, so no product can be hoisted out of the loop, and no block needs
// another block's rows: no grid-wide synchronisation. Each step is a few
// phases separated by __syncthreads:
//   - the matrix-vector products (gates, q, logits; in the backward the
//     transposed ones) share gemv_partials: a work item owns 16 bytes of
//     adjacent output columns (4 in f32, 8 in bf16) and one of S splits of
//     the depth, reads its weights as one 16-byte load a row, the threads
//     of a warp on neighbouring columns, and multiplies each weight into
//     the block's rows; the S partial sums go through shared memory;
//   - the context, and the backward's dqb, are such products too, one
//     row at a time, the row's own frames (enc, enc_proj) its weights;
//   - the scores, and the backward's attention gradient, 8 lanes per
//     (row, frame), along the enc_proj / enc row 16 bytes at a time;
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
// the bytes). The design keeps the weight reads coalesced, 16 bytes a
// load, several loads issued before their products, S splits of the depth
// in flight per column group, and reuses each weight for kRows rows.
// Keeping the weights resident in shared memory across a thread-block
// cluster (each block a slice of the gate columns, h exchanged through
// distributed shared memory) and wgmma for the per-step products are the
// route to a faster kernel.

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
  int B, L, T, D, A, E, H, V;
  float scale;
};

// Shared-memory plan of the forward, in floats.
struct FwdSmem {
  size_t xv, hc, cs, q, sc, lg, part, total;
  __host__ __device__ FwdSmem(int T, int D, int A, int E, int H, int V,
                             int cols) {
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
    total = o + p;
  }
};

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int tok_s[kRows], pred_s[kRows], len_s[kRows];
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V;
  const int KX = E + D + H, HD = H + D, H4 = 4 * H;
  const FwdSmem plan(T, D, A, E, H, V, Pack<WT>::kN);
  float* xv = sm + plan.xv;
  float* hc = sm + plan.hc;
  float* cs = sm + plan.cs;
  float* q = sm + plan.q;
  float* sc = sm + plan.sc;
  float* lg = sm + plan.lg;
  float* part = sm + plan.part;
  const WT* enc = static_cast<const WT*>(a.enc);
  const WT* encp = static_cast<const WT*>(a.encp);
  const WT* embed = static_cast<const WT*>(a.embed);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int b0 = blockIdx.x * kRows;

  for (int k = tid; k < (int)plan.part; k += nt) sm[k] = 0.0f;
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
    frame_dots(encp + (size_t)b0 * T * A, (size_t)T * A, A, q, A, len_s, T,
               a.scale, sc);
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
        sc[r * T + t] = rnd<WT>(w);  // the context's operand
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
  const float* c_seq;      // [B,L,H]
  const float* acts;       // [B,L,4H]
  const float* att_seq;    // [B,L,T]
  float* dgates;           // [B,L,4H]
  float* dctx;             // [B,L,D]
  float* dqb;              // [B,L,A]
  float* demb;             // [B,L,E]
  float* dsn;              // [B,L,T]
  int B, L, T, D, A, E, H, V;
  float scale;
};

struct BwdSmem {
  size_t vin, kv, dctx_r, dh_tot, dh, dc, dctxc, sc, part, total;
  __host__ __device__ BwdSmem(int T, int D, int A, int E, int H, int V,
                             int cols) {
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
    total = o + p;
  }
};

template <typename WT>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int len_s[kRows];
  const int B = a.B, L = a.L, T = a.T, D = a.D, A = a.A, E = a.E, H = a.H,
            V = a.V;
  const int HD = H + D, H4 = 4 * H, KX = E + D + H;
  const BwdSmem plan(T, D, A, E, H, V, Pack<WT>::kN);
  const int KV = (int)plan.kv;
  float* vin = sm + plan.vin;
  float* dctx_r = sm + plan.dctx_r;
  float* dh_tot = sm + plan.dh_tot;
  float* dh = sm + plan.dh;
  float* dc = sm + plan.dc;
  float* dctxc = sm + plan.dctxc;
  float* sc = sm + plan.sc;
  float* part = sm + plan.part;
  const WT* enc = static_cast<const WT*>(a.enc);
  const WT* encp = static_cast<const WT*>(a.encp);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int b0 = blockIdx.x * kRows;

  for (int k = tid; k < (int)plan.part; k += nt) sm[k] = 0.0f;
  if (tid < kRows) len_s[tid] = b0 + tid < B ? min(max(a.enc_len[b0 + tid], 0), T) : 0;
  __syncthreads();

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
    for (int r = warp; r < kRows; r += nw) {
      const int n = len_s[r], b = b0 + r;
      if (b >= B) continue;
      const float* al = a.att_seq + ((size_t)b * L + i) * T;
      float tot = 0.0f;
      for (int t = lane; t < n; t += 32) tot = fmaf(sc[r * T + t], al[t], tot);
      tot = warp_sum(tot);
      float* out = a.dsn + ((size_t)b * L + i) * T;
      for (int t = lane; t < T; t += 32) {
        const float v = t < n ? al[t] * (sc[r * T + t] - tot) * a.scale : 0.0f;
        sc[r * T + t] = v;
        out[t] = v;
      }
    }
    __syncthreads();

    // dqb[r] = dsn[r] . enc_proj[r] (dsn in f32, as the TPU kernel).
    gemv_rows(sc, T, len_s, encp + (size_t)b0 * T * A, (size_t)T * A, A, part);
    __syncthreads();
    for (int k = tid; k < kRows * A; k += nt) {
      const int r = k / A, n = k % A, b = b0 + r;
      const float acc = gemv_row_sum<WT>(part, A, r, n);
      vin[r * KV + n] = rnd<WT>(acc);
      if (b < B) a.dqb[((size_t)b * L + i) * A + n] = acc;
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

template <typename WT>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * FwdSmem(a.T, a.D, a.A, a.E, a.H, a.V, Pack<WT>::kN).total;
  cudaError_t e = set_smem(fwd_kernel<WT>, bytes);
  if (e != cudaSuccess) return e;
  fwd_kernel<WT><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_bwd(const BwdArgs& a, const float* q_seq, float* d_encp,
                       cudaStream_t st) {
  const size_t bytes = sizeof(float) * BwdSmem(a.T, a.D, a.A, a.E, a.H, a.V, Pack<WT>::kN).total;
  cudaError_t e = set_smem(bwd_kernel<WT>, bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<WT><<<(a.B + kRows - 1) / kRows, kThreads, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kTT - 1) / kTT, a.B);
  d_encp_kernel<<<grid, kEncpThreads, 0, st>>>(a.dsn, q_seq, d_encp, a.L, a.T, a.A);
  return cudaGetLastError();
}

bool dims_ok(int B, int L, int T, int D, int A, int E, int H, int V) {
  return B > 0 && L > 0 && T > 0 && D > 0 && A > 0 && E > 0 && H > 0 &&
         H <= 1024 && V > 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers in the layouts
// of FwdArgs / BwdArgs above; the WT operands are float when cd_bf16 == 0
// and __nv_bfloat16 when cd_bf16 == 1, 16-byte aligned. Each returns
// cudaGetLastError() after its launches (0 on success), or
// cudaErrorInvalidValue for a shape the kernels cannot take (a block's
// shared memory grows with T, D, E, H and V).
extern "C" int las_decoder_fwd(
    const int* tokens, const uint8_t* coins, const int* enc_len,
    const void* enc, const void* encp, const void* embed, const void* wcat,
    const float* b_x, const void* att_q, const float* att_b,
    const void* w_out, const float* b_out, float* logits, float* h_seq,
    float* c_seq, float* acts, float* q_seq, float* att_seq, float* ctx_seq,
    int* tok_seq, int B, int L, int T, int D, int A, int E, int H, int V,
    float scale, int cd_bf16, void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{tokens, coins, enc_len, enc, encp, embed, wcat, b_x, att_q,
                  att_b, w_out, b_out, logits, h_seq, c_seq, acts, q_seq,
                  att_seq, ctx_seq, tok_seq, B, L, T, D, A, E, H, V, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cd_bf16 ? launch_fwd<__nv_bfloat16>(a, st) : launch_fwd<float>(a, st));
}

extern "C" int las_decoder_bwd(
    const float* dlogits, const int* enc_len, const void* enc,
    const void* encp, const void* woutT, const void* attqT, const void* wcatT,
    const float* c_seq, const float* acts, const float* att_seq,
    const float* q_seq, float* dgates, float* dctx, float* dqb, float* demb,
    float* dsn, float* d_encp, int B, int L, int T, int D, int A, int E,
    int H, int V, float scale, int cd_bf16, void* stream) {
  if (!dims_ok(B, L, T, D, A, E, H, V)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{dlogits, enc_len, enc, encp, woutT, attqT, wcatT, c_seq,
                  acts, att_seq, dgates, dctx, dqb, demb, dsn,
                  B, L, T, D, A, E, H, V, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cd_bf16 ? launch_bwd<__nv_bfloat16>(a, q_seq, d_encp, st)
                       : launch_bwd<float>(a, q_seq, d_encp, st));
}

extern "C" const char* las_decoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
