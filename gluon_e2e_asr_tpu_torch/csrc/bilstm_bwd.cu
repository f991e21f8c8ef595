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
//   (a) bwd_recur_kernel: one persistent block per (direction, group of
//       kRows batch rows) loops over time; thread u owns hidden unit u and
//       its four gate derivatives for the block's rows. It writes dg to
//       device memory (f32) and, rounded to the compute dtype, to shared
//       memory (double buffered, one barrier a step), from which it forms
//       its own entry of dh_rec = dg . W_h^T. The caller passes W_h in
//       the layout wt[(q*H + u)*4 + e] = W_h[u][4q + e]: the four weights
//       of unit u that meet dg columns 4q..4q+3 are one vector load, and
//       neighbouring threads load neighbouring vectors (coalesced).
//   (b) the products dx, dW_x and dW_h through gemm.cuh (bf16 on the
//       tensor cores or f32 on the FMA units); the weight gradients split
//       their long depth (B*T) over blocks and add atomically.
//   (c) colsum_kernel: db.
//
// What bounds it on the card: as in K1-fwd, the recurrence. Every step
// every block reads all of W_h (0.8 MB in bf16 at H=320) from L2 and does
// kRows*4H*H FMAs, and a step cannot start before the previous one ended.
// The design keeps those reads coalesced and vectorised with 16 loads in
// flight a thread. Keeping W_h resident across a cluster is the route to
// a faster kernel, for both directions of K1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"

namespace {

using port::load4;
using port::round_bf16;

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

// h_prev of one direction as the A operand of dW_h = h_prev^T . dg:
// (u, row) with row = b*T + t reads the h stream y [B,T,2H] at t-1
// (forward direction) or t+1 (backward direction), 0 outside [0, T).
struct HPrevT {
  const float* y;
  int T, H, M, dir;
  bool vec;  // gemm::vec_ok(y + dir * H, 2 * H)
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
    return (r < 0 || u >= H) ? 0.0f : y[(size_t)r * 2 * H + dir * H + u];
  }
  __device__ __forceinline__ float4 four(int u, int row) const {
    const int r = src(row);
    if (vec && r >= 0 && u + 3 < H)
      return *reinterpret_cast<const float4*>(y + (size_t)r * 2 * H + dir * H + u);
    return make_float4((*this)(u, row), (*this)(u + 1, row),
                       (*this)(u + 2, row), (*this)(u + 3, row));
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

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// x [B,T,D], wx [D,8H], y and cs [B,T,2H] (K1-fwd's h and c streams),
// acts [B,T,8H] (K1-fwd's training-form xg buffer), dy [B,T,2H], all f32;
// wtf/wtb are W_h in the layout of bwd_recur_kernel, float when
// cd_bf16 == 0 and __nv_bfloat16 when cd_bf16 == 1. dg [B,T,8H] is
// caller-allocated scratch. Outputs, f32: dx [B,T,D], dwx [D,8H], db [8H],
// dwhf and dwhb [H,4H]. Returns cudaGetLastError() after the launches (0
// on success).
extern "C" int bilstm_bwd(const float* x, const int* lens, const float* wx,
                          const void* wtf, const void* wtb, const float* y,
                          const float* cs, const float* acts, const float* dy,
                          float* dg, float* dx, float* dwx, float* db,
                          float* dwhf, float* dwhb, int B, int T, int D, int H,
                          int cd_bf16, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || H <= 0 || H > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int N8 = 8 * H, N4 = 4 * H;
  const bool bf16 = cd_bf16 != 0;

  cudaError_t e = bf16
      ? launch_bwd_recur<__nv_bfloat16>(dy, lens, acts, cs, wtf, wtb, dg, B,
                                        T, H, 1, st)
      : launch_bwd_recur<float>(dy, lens, acts, cs, wtf, wtb, dg, B, T, H, 0,
                                st);
  if (e != cudaSuccess) return (int)e;

  const size_t f = sizeof(float);
  if ((e = cudaMemsetAsync(dwx, 0, f * D * N8, st)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(db, 0, f * N8, st)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(dwhf, 0, f * H * N4, st)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(dwhb, 0, f * H * N4, st)) != cudaSuccess) return (int)e;

  const gemm::RowMajor dg_all{dg, N8, M, N8, gemm::vec_ok(dg, N8)};
  // dx [M, D] = dg [M, 8H] . W_x^T
  e = gemm::launch(dg_all, gemm::Transposed{wx, N8, N8, D, gemm::vec_ok(wx, N8)},
                   gemm::Store{dx, D}, M, D, N8, 1, bf16, st);
  if (e != cudaSuccess) return (int)e;
  // dW_x [D, 8H] = x^T . dg
  e = gemm::launch(gemm::Transposed{x, D, D, M, gemm::vec_ok(x, D)}, dg_all,
                   gemm::AtomicAdd{dwx, N8}, D, N8, M,
                   gemm::split_k(D, N8, M), bf16, st);
  if (e != cudaSuccess) return (int)e;
  // dW_h [H, 4H] = h_prev^T . dg, per direction
  for (int dir = 0; dir < 2; ++dir) {
    const float* dgd = dg + dir * N4;
    e = gemm::launch(HPrevT{y, T, H, M, dir, gemm::vec_ok(y + dir * H, 2 * H)},
                     gemm::RowMajor{dgd, N8, M, N4, gemm::vec_ok(dgd, N8)},
                     gemm::AtomicAdd{dir ? dwhb : dwhf, N4}, H, N4, M,
                     gemm::split_k(H, N4, M), bf16, st);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int kColThreads = 256, kColRows = 512;
  const dim3 cgrid((N8 + kColThreads - 1) / kColThreads,
                   (M + kColRows - 1) / kColRows);
  colsum_kernel<<<cgrid, kColThreads, 0, st>>>(dg, db, M, N8, kColRows);
  return (int)cudaGetLastError();
}

extern "C" const char* bilstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
