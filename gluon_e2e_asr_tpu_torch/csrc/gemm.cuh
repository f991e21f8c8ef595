// Tiled matrix products for the port's kernels, for Hopper (sm_90a).
//
// The generalisation of bilstm_fwd.cu's projection kernels
// (proj_f32_kernel, proj_bf16_kernel) to operands read through accessors.
// K1-bwd (bilstm_bwd.cu) multiplies transposed and time-shifted operands
// (dx = dg . W_x^T, dW_x = x^T . dg, dW_h = h_prev^T . dg), which the
// forward's row-major loads cannot express. Same tiles, 128 x 128 outputs
// a block, 256 threads:
//
//   gemm_f32_kernel:  k-tiles of 8 in shared memory, 8 x 8 outputs a thread
//                     on the FMA units (true f32);
//   gemm_bf16_kernel: k-tiles of 32; the operands are rounded to bf16 on
//                     their way to shared memory and multiplied on the
//                     tensor cores (WMMA 16x16x16, f32 accumulation). A
//                     product of two bf16 values is exact in f32, so this
//                     is the bf16 matmul with f32 accumulation of the JAX
//                     kernels (preferred_element_type=float32). Each
//                     thread loads its share of a tile as float4 along
//                     the operand's contiguous index, the next tile's
//                     loads in flight while the current one is
//                     multiplied; each tile keeps that index contiguous
//                     in shared memory, and WMMA reads a transposed
//                     operand as a col_major fragment.
//
// An accessor is a functor  float operator()(int r, int c) const  that
// returns 0 outside its operand, and  float4 four(int r, int c) const
// that returns the four elements from (r, c) along its contiguous index
// (kFirstContig is true when consecutive r are adjacent in memory). The
// tile loads walk the contiguous index fastest, so neighbouring threads
// read neighbouring addresses. A is read as (m, k) and B as (k, n).
// blockIdx.z splits K (split-K: each split adds its partial sum through
// an AtomicAdd epilogue into a zeroed output, so the order of those few
// additions varies from run to run); a split's bounds are multiples of 4
// (of the tile depth, in fact), so a vector along k never crosses one.
// What bounds these products: global loads, one register stage deep.
// The bf16 products of K1-bwd and K7-bwd now run on wgmma, fed by TMA
// through a multi-stage ring (gemm_sm90.cuh), and the f32 ones on
// gemm_f32.cuh's ring_kernel, fed by cp.async through a ring of four
// stages, which reads its operands through these accessors (and writes
// through epilogues of its own). Both kernels here are on no model path and
// remain as build variants that the probes time beside their successors:
// gemm_bf16_kernel (bilstm_bwd.cu's K1B_WGMMA_PRODUCTS 0, tools/
// k1b_probe.py --products) and gemm_f32_kernel (K1_F32_TILED 0,
// tools/k1b_probe.py --products --dtype float32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;
constexpr int kF32K = 8;          // k per tile, f32 kernel
constexpr int kPad = 4;           // keeps the f32 A tile free of bank conflicts
constexpr int kTK = 32;           // k per tile, bf16 kernel
constexpr int kSkew = 8;          // bf16 padding of a shared-memory row

// True when float4 loads at p + i * ld + 4 * j are aligned.
inline bool vec_ok(const float* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

// Row-major [rows, cols], leading dimension ld: (r, c) -> p[r * ld + c].
struct RowMajor {
  const float* p;
  int ld, rows, cols;
  bool vec;  // vec_ok(p, ld)
  static constexpr bool kFirstContig = false;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return (r < rows && c < cols) ? p[(size_t)r * ld + c] : 0.0f;
  }
  __device__ __forceinline__ float4 four(int r, int c) const {
    if (vec && r < rows && c + 3 < cols)
      return *reinterpret_cast<const float4*>(p + (size_t)r * ld + c);
    return make_float4((*this)(r, c), (*this)(r, c + 1), (*this)(r, c + 2),
                       (*this)(r, c + 3));
  }
  // gemm_f32.cuh's operand interface
  __device__ __forceinline__ int span(int r, int c) const {
    return r < rows && c < cols ? min(4, cols - c) : 0;
  }
  __device__ __forceinline__ const float* addr(int r, int c) const {
    return p + (size_t)r * ld + c;
  }
  __device__ __forceinline__ const float* base() const { return p; }
};

// The transpose of a row-major [cols, rows] array: (r, c) -> p[c * ld + r].
struct Transposed {
  const float* p;
  int ld, rows, cols;
  bool vec;  // vec_ok(p, ld)
  static constexpr bool kFirstContig = true;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return (r < rows && c < cols) ? p[(size_t)c * ld + r] : 0.0f;
  }
  __device__ __forceinline__ float4 four(int r, int c) const {
    if (vec && c < cols && r + 3 < rows)
      return *reinterpret_cast<const float4*>(p + (size_t)c * ld + r);
    return make_float4((*this)(r, c), (*this)(r + 1, c), (*this)(r + 2, c),
                       (*this)(r + 3, c));
  }
  // gemm_f32.cuh's operand interface
  __device__ __forceinline__ int span(int r, int c) const {
    return r < rows && c < cols ? min(4, rows - r) : 0;
  }
  __device__ __forceinline__ const float* addr(int r, int c) const {
    return p + (size_t)c * ld + r;
  }
  __device__ __forceinline__ const float* base() const { return p; }
};

// The epilogues.
struct Store {
  float* p;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    p[(size_t)m * ld + n] = v;
  }
};

// Adds into a zeroed output: split-K's partial sums, in an order that
// varies from run to run. Only the build variants K1_F32_TILED 0 and
// K1B_WGMMA_PRODUCTS 0 (bilstm_bwd.cu's tiled_products, which only the
// probes build) use it: the model path's products sum their splits in a
// fixed order (split_sum.cuh).
struct AtomicAdd {
  float* p;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    atomicAdd(p + (size_t)m * ld + n, v);
  }
};

// Element e of an R x C tile, walking the contiguous index fastest; with
// kVec = 4, the first element of vector e.
template <bool kFirstContig, int R, int C, int kVec = 1>
__device__ __forceinline__ void tile_pos(int e, int& r, int& c) {
  if (kFirstContig) {
    r = e % (R / kVec) * kVec;
    c = e / (R / kVec);
  } else {
    r = e / (C / kVec);
    c = e % (C / kVec) * kVec;
  }
}

template <class A, class B, class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(A a, B b, Epi epi, int M, int N, int K, int kchunk) {
  __shared__ __align__(16) float As[kF32K][kBM + kPad];
  __shared__ __align__(16) float Bs[kF32K][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kF32K) {
#pragma unroll
    for (int j = 0; j < kBM * kF32K / kThreads; ++j) {
      const int e = tid + j * kThreads;
      int r, kk;
      tile_pos<A::kFirstContig, kBM, kF32K>(e, r, kk);
      As[kk][r] = (k0 + kk < k_end) ? a(m0 + r, k0 + kk) : 0.0f;
      int c;
      tile_pos<B::kFirstContig, kF32K, kBN>(e, kk, c);
      Bs[kk][c] = (k0 + kk < k_end) ? b(k0 + kk, n0 + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

// A bf16 operand tile in shared memory, R x C in (r, c) order as the
// accessor reads it: stored [R][C + skew] when c is contiguous in memory
// (row_major for WMMA), [C][R + skew] when r is (col_major).
template <bool kFirstContig, int R, int C>
struct Tile {
  static constexpr int kRows = kFirstContig ? C : R;
  static constexpr int kLd = (kFirstContig ? R : C) + kSkew;
  using Layout = std::conditional_t<kFirstContig, nvcuda::wmma::col_major,
                                    nvcuda::wmma::row_major>;
  __device__ __forceinline__ static int at(int r, int c) {
    return kFirstContig ? c * kLd + r : r * kLd + c;
  }
};

// 8 warps as 2 (rows) x 4 (columns); each warp owns a 64 x 32 patch of
// the tile as 4 x 2 WMMA accumulators.
template <class A, class B, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(A a, B b, Epi epi, int M, int N, int K, int kchunk) {
  namespace wmma = nvcuda::wmma;
  using TA = Tile<A::kFirstContig, kBM, kTK>;  // (m, k)
  using TB = Tile<B::kFirstContig, kTK, kBN>;  // (k, n)
  __shared__ __align__(32) __nv_bfloat16 As[TA::kRows * TA::kLd];
  __shared__ __align__(32) __nv_bfloat16 Bs[TB::kRows * TB::kLd];
  __shared__ __align__(32) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // A thread's share of the next tile, in registers while the current
  // tile is multiplied: kVecs float4 of each operand.
  constexpr int kVecs = kBM * kTK / 4 / kThreads;
  static_assert(kVecs * 4 * kThreads == kTK * kBN, "A and B tiles differ");
  float4 ra[kVecs], rb[kVecs];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kVecs; ++e) {
      const int v = tid + e * kThreads;
      int r, kk, c;
      tile_pos<A::kFirstContig, kBM, kTK, 4>(v, r, kk);
      ra[e] = k0 + kk < k_end ? a.four(m0 + r, k0 + kk) : zero;
      tile_pos<B::kFirstContig, kTK, kBN, 4>(v, kk, c);
      rb[e] = k0 + kk < k_end ? b.four(k0 + kk, n0 + c) : zero;
    }
  };
  // The four values lie contiguous in the tile's shared-memory order.
  auto put = [](__nv_bfloat16* dst, float4 x) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
    d[0] = __floats2bfloat162_rn(x.x, x.y);
    d[1] = __floats2bfloat162_rn(x.z, x.w);
  };
  auto stash = [&]() {
#pragma unroll
    for (int e = 0; e < kVecs; ++e) {
      const int v = tid + e * kThreads;
      int r, kk, c;
      tile_pos<A::kFirstContig, kBM, kTK, 4>(v, r, kk);
      put(&As[TA::at(r, kk)], ra[e]);
      tile_pos<B::kFirstContig, kTK, kBN, 4>(v, kk, c);
      put(&Bs[TB::at(kk, c)], rb[e]);
    }
  };

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    stash();
    __syncthreads();
    if (k0 + kTK < k_end) fetch(k0 + kTK);
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     typename TA::Layout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     typename TB::Layout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[TA::at(wm * 64 + i * 16, kk)], TA::kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[TB::at(kk, wn * 32 + j * 16)], TB::kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue, one 16 x 16 accumulator at a time through the warp's scratch.
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
        if (m < M && n < N) epi(m, n, cs[e]);
      }
      __syncwarp();
    }
  }
}

// K-splits for an M x N output: about two blocks per SM in flight, and
// at least 512 of K per split.
inline int split_k(int M, int N, int K) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int want = (264 + tiles - 1) / tiles;
  const int most = K / 512 > 1 ? K / 512 : 1;
  return want < most ? want : most;
}

// C = A . B (M x N, depth K) on stream st, in bf16 on the tensor cores
// (kBf16) or in f32 on the FMA units; only the kernel asked for is
// compiled. With splits > 1 the epilogue must accumulate.
template <bool kBf16, class A, class B, class Epi>
cudaError_t launch(A a, B b, Epi epi, int M, int N, int K, int splits,
                   cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  const int step = kBf16 ? kTK : kF32K;
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + step - 1) / step * step;
  const int nsplit = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, nsplit);
  if constexpr (kBf16) {
    gemm_bf16_kernel<A, B, Epi><<<grid, kThreads, 0, st>>>(a, b, epi, M, N, K, kchunk);
  } else {
    gemm_f32_kernel<A, B, Epi><<<grid, kThreads, 0, st>>>(a, b, epi, M, N, K, kchunk);
  }
  return cudaGetLastError();
}

}  // namespace gemm
