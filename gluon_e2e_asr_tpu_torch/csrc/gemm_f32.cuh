// K1's f32 matrix products on the FMA units, for Hopper (sm_90a): one GEMM
// core, ring_kernel, for K1-fwd's f32 projection (bilstm_fwd.cu) and
// K1-bwd's f32 products (bilstm_bwd.cu; also K7-bwd's f32 dW_h and its
// gate recompute, bilstm_v1_gates).
//
// Serves the f32 matmuls of the TPU kernels
//   gluon_e2e_asr_tpu/ops/pallas_lstm.py::_v2_fwd_kernel :426-437, the
//     projection xg = x . W_x + b with the backward half 0 past lens
//     (bilstm_fused -> _v2_fwd_impl :841 -> pl.pallas_call), and
//   _v2_bwd_kernel :617-643, dx = dg . W_x^T, dW_x = x^T . dg, dW_h =
//     h_prev^T . dg and db = the sum of dg (its VJP -> _v2_vjp_bwd :931),
// with compute_dtype float32: true f32 products (no TF32, no 3xTF32); only
// the order of the sums differs from the plain twins.
//
// What bounds them on the H100: operations, at the FMA units' 67 TFLOP/s
// (utils/flops.py). At the milestones' 4.0 s bucket (B=16, H=256, layers
// (T, D) = (398, 80), (199, 1024), (100, 1024)) the products do 10.9 +
// 30.1 + 15.1 GFLOP with every frame live and the projection 2.1 + 13.4 +
// 6.7, against at most 0.1 GB of operands a layer: 10-100 times more
// operations a byte than the FMA units need. To issue 128 FMAs a clock an
// SM, the FMAs must not wait on shared memory (128 bytes a clock an SM) or
// on device memory. The kernels they replace, gemm.cuh's gemm_f32_kernel
// and bilstm_fwd.cu's proj_f32_kernel (build variants now: K1_F32_TILED
// 0), filled 8-deep k-tiles by scalar loads behind one register stage and
// two barriers, and walked every frame: 7-29% of the bound (PERF.md).
//
// The design:
//   * 128 x 128 outputs a block, 256 threads: 8 warps as 4 x 2 patches of
//     32 x 64, a warp's lanes as 4 x 8, 8 x 8 outputs a lane (row_of,
//     col_of): 16 FMAs for every 16-byte shared load. (A tile of 8 x 16
//     a thread, 21 FMAs a load at 128 threads a block, ran slower on the
//     H100: PERF.md.) __launch_bounds__(256, 2): two blocks an SM (at
//     most 128 registers a thread, 80 KB of shared memory a block).
//   * A ring of kStages = 4 stages of k-tiles kBK = 16 deep in dynamic
//     shared memory, filled by 16-byte cp.async (4-byte copies where an
//     operand is not 16-byte aligned; the copy's source size zero-fills
//     past an operand's edge): three tiles in flight while the current one
//     is multiplied, one barrier a stage.
//   * Each operand keeps its contiguous global index contiguous in shared
//     memory. Contiguous along its outer index (m for A, n for B): the
//     stage is [kBK][128], read as float4 along it (x^T in dW_x, h_prev^T
//     in dW_h, dg in the weight gradients, W_x in the projection).
//     Contiguous along k: [128][kBK + 4], read as a float4 of 4 k's a row
//     (x in the projection, h_prev in the gate recompute) or, where both
//     operands are (dg and W_x^T in dx), as a float2 of 2 k's a row and a
//     column, so that both fit in registers beside the accumulators. A
//     thread's rows (columns) are then 4 (8) apart: a quarter warp's
//     lanes read one row, or 8 adjacent columns 20 floats apart, which the
//     4-float skew puts in distinct bank groups.
//   * The walk over k in tiles of kBK. The weight gradients' depth is the
//     frame b*T + t: a tile none of whose frames is live (t < lens[b]) is
//     skipped by every thread alike, costing no stage and no barrier (dg
//     is 0 past lens: bilstm_bwd.cu's contract), as gemm_sm90.cuh's
//     wgrad_kernel skips its dead units.
//   * Split-K (gridDim.z, splits()): where the output's tiles fill less
//     than one wave of two blocks an SM (dW_x at layer 0 is 80 x 2048:
//     16 tiles; dW_h 256 x 1024), split s of S takes the k-tiles s, s + S,
//     s + 2S, ...: the live frames, a prefix of each utterance, spread
//     evenly over the splits, where contiguous ranges left some splits
//     twice the live tiles of others. Each split stores its whole partial
//     tile (SplitStore: split 0 into the output, split s > 0 into slice
//     s - 1 of a workspace; zeros where it met no live tile), and
//     split_sum.cuh adds them in the order 0, 1, ..., S - 1 after the
//     launch: no float atomics, the same bits on every run (the splits'
//     k-tiles and the live-first rows set the speed, not that order).
//   * db: the dW_x blocks of the first row tile sum the staged dg tiles'
//     columns as they pass, in place of a second pass over dg: each half
//     of the block (tid / 128) its share of a stage's kBK rows, stored as
//     a partial row of its own (2 a split), which split_sum.cuh adds up
//     in a fixed order too.
//   * Two jobs of one shape in one launch (dW_h of both directions): more
//     output tiles, so fewer splits and longer walks a block.
//   * Live rows first: where the rows are frames and the product is 0 past
//     lens (dx's rows; the projection's backward half), a block's row tile
//     takes the frames at its positions of the order "every live frame,
//     then every other" (LiveRows), so that the blocks past the live
//     frames hold only dead ones: they skip the product and write zeros
//     (their partial tiles too, when split). The rows' addresses go
//     through a table in shared memory; the loads of a row tile gather
//     rows, 64 bytes at a time.
//
// Operands are accessors (gemm.cuh's RowMajor and Transposed,
// bilstm_bwd.cu's HPrevT and HPrev): A read as (m, k), B as (k, n), with
//   kFirstContig            true when the first index is contiguous;
//   vec                     16-byte copies allowed (16-byte aligned rows);
//   int span(r, c)          elements in range from (r, c) along the
//                           contiguous index, at most 4 (0 outside);
//   const float* addr(r, c) that element's address (where span > 0);
//   const float* base()     any address inside the operand.
// Epilogues (SplitStore's SplitPart, bilstm_fwd.cu's ProjEpi,
// bilstm_bwd.cu's GateActs): operator()(m, n, v) and four(m, n, v, cols)
// for columns n .. n + cols - 1 (cols <= 4); each element of the output
// is stored once, by one thread (a SplitStore: once a split).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gemm_f32 {

constexpr int kBM = 128;          // output rows a block
constexpr int kBN = 128;          // output columns a block
constexpr int kBK = 16;           // depth of a stage
constexpr int kStages = 4;        // the ring
constexpr int kThreads = 256;     // 8 warps, 8 x 8 outputs a thread
constexpr int kBlocksPerSm = 2;   // __launch_bounds__'s minimum
constexpr int kSkew = 4;          // floats after each row of kBK
constexpr int kMinTiles = 8;      // k-tiles a split, at least

// Floats of one operand's stage: [kBK][128] when it is contiguous along
// its outer index, [128][kBK + kSkew] when along k.
template <bool kOuter>
struct Stage {
  static constexpr int kFloats = kOuter ? kBK * 128 : 128 * (kBK + kSkew);
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The k-split of an M x N output of depth K: the most splits that keep
// the blocks within one wave of kBlocksPerSm blocks on each of `sms` SMs,
// each split at least kMinTiles k-tiles (tests/test_torch_bilstm_products.py
// mirrors it).
inline int splits(int M, int N, int K, int sms) {
  const int tiles = cdiv(M, kBM) * cdiv(N, kBN);
  const int want = kBlocksPerSm * sms / tiles;
  const int most = cdiv(K, kBK) / kMinTiles;
  const int s = want < most ? want : most;
  return s > 1 ? s : 1;
}

// One split's epilogue of a SplitStore: stores into p (rows of ld floats),
// 16 bytes at a time where vec.
struct SplitPart {
  float* p;
  int ld;
  bool vec;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    p[(size_t)m * ld + n] = v;
  }
  __device__ __forceinline__ void four(int m, int n, float4 v, int cols) const {
    if (vec && cols == 4) {
      *reinterpret_cast<float4*>(p + (size_t)m * ld + n) = v;
      return;
    }
    const float w[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < cols; ++i) (*this)(m, n + i, w[i]);
  }
};

// Split-K's partial tiles, for split_sum.cuh to add in a fixed order:
// split 0 stores into the output `out`, split s > 0 into slice s - 1 of
// the workspace `ws` (slices `slice` floats apart, rows of ld floats as
// the output's). vec: out and ws 16-byte aligned, ld and slice multiples
// of 4.
struct SplitStore {
  float* out;
  float* ws;
  long long slice;
  int ld;
  bool vec;
};

// The epilogue of split s: a SplitStore's part, any other epilogue itself
// (those run unsplit).
template <class Epi>
__device__ __forceinline__ Epi split_part(const Epi& e, int) {
  return e;
}
__device__ __forceinline__ SplitPart split_part(const SplitStore& e, int s) {
  return SplitPart{s == 0 ? e.out : e.ws + (s - 1) * e.slice, e.ld, e.vec};
}

// The walk over k where k is a frame b*T + t of K = B*T: a tile of kBK
// frames is live when one of them is (t < lens[b]). lens null: every
// tile.
struct Frames {
  const int* lens;
  int T, K;
  __device__ __forceinline__ bool live(int k0) const {
    if (lens == nullptr) return true;
    const int k1 = min(k0 + kBK, K);
    for (int b = k0 / T; b * T < k1; ++b) {
      if (max(k0, b * T) - b * T < __ldg(lens + b)) return true;
    }
    return false;
  }
};

// The rows of the column tiles from column n_from on, where a row is a
// frame m = b*T + t of M = B*T: the live frames (t < lens[b]) first, in
// order, then the others (live_first); a block's row tile of frames that
// are all past their lengths skips its product. lens null: rows in order,
// none skipped.
struct LiveRows {
  const int* lens;
  int T, n_from;
  // The frame at position j of the live-first order of B utterances.
  __device__ __forceinline__ int live_first(int j, int B) const {
    int live = 0;
    for (int b = 0; b < B; ++b) live += __ldg(lens + b);
    int at = j < live ? j : j - live;
    for (int b = 0; b < B; ++b) {
      const int len = __ldg(lens + b);
      const int n = j < live ? len : T - len;
      if (at < n) return b * T + (j < live ? at : len + at);
      at -= n;
    }
    return -1;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory, the last 16 - 4n zero-filled.
__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(4 * n)
               : "memory");
}

// 4 bytes, or a zero where !valid.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One operand's k-tile [o0, o0 + 128) x [k0, k0 + kBK) into stage s: 512
// chunks of 4 floats along the contiguous index, two a thread, a warp's
// chunks neighbouring in memory. kIsB: the accessor reads (k, o). rows
// (A along k only): the operand's row of each of the tile's 128, -1 for
// none, in place of o0 + o.
template <bool kIsB, bool kOuter, class Op>
__device__ __forceinline__ void load_tile(const Op& op, float* s, int o0,
                                          int k0, const int* rows) {
  constexpr int kChunks = 128 * kBK / 4;
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    int o, k;
    float* dst;
    if (kOuter) {
      k = e / 32;
      o = e % 32 * 4;
      dst = s + k * 128 + o;
    } else {
      o = e / (kBK / 4);
      k = e % (kBK / 4) * 4;
      dst = s + o * (kBK + kSkew) + k;
    }
    const int oo = !kIsB && !kOuter && rows != nullptr ? rows[o] : o0 + o;
    const int r = kIsB ? k0 + k : oo;
    const int c = kIsB ? oo : k0 + k;
    const int n = oo < 0 ? 0 : op.span(r, c);
    const float* src = n > 0 ? op.addr(r, c) : op.base();
    if (op.vec) {
      cp16(dst, src, n);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) cp4(dst + i, i < n ? src + i : op.base(), i < n);
    }
  }
}

// The warps as 4 (rows) x 2 (columns), a 32 x 64 patch each; a warp's
// lanes as 4 x 8 (lr = lane / 8, lc = lane % 8), 8 x 8 outputs a lane. A
// thread's 8 rows of the block tile, by A's stage layout: along its outer
// index 4 + 4 adjacent rows (two float4 a k), along k 8 rows 4 apart (a
// float4 of 4 k's each; a quarter warp's lanes share one row). Its 8
// columns likewise by B's: 4 + 4 adjacent, or 8 columns 8 apart (a
// quarter warp's lanes read 8 adjacent columns).
template <bool kOuter>
__device__ __forceinline__ int row_of(int tid, int i) {
  const int lane = tid % 32, base = tid / 32 / 2 * 32, lr = lane / 8;
  return base + (kOuter ? (i < 4 ? lr * 4 + i : 16 + lr * 4 + (i - 4))
                        : lr + 4 * i);
}

template <bool kOuter>
__device__ __forceinline__ int col_of(int tid, int j) {
  const int lane = tid % 32, base = tid / 32 % 2 * 64, lc = lane % 8;
  return base + (kOuter ? (j < 4 ? lc * 4 + j : 32 + lc * 4 + (j - 4))
                        : lc + 8 * j);
}

// acc += the stage's A [128 x kBK] . B [kBK x 128] on the thread's 8 x 8
// outputs, in k order: 16 16-byte loads (or their bytes in 8-byte loads)
// for every 256 FMAs.
template <bool kAOuter, bool kBOuter>
__device__ __forceinline__ void multiply(const float* As, const float* Bs,
                                         float (&acc)[8][8], int tid) {
  static_assert(kBOuter || !kAOuter,
                "no product reads A along its outer index and B along k");
  constexpr int P = kBK + kSkew;
  const auto arow = [tid](int i) { return row_of<kAOuter>(tid, i); };
  const auto bcol = [tid](int j) { return col_of<kBOuter>(tid, j); };
  if constexpr (kAOuter) {
    // a k at a time: two float4 of A, two of B, 64 FMAs (ptxas issues the
    // next k's loads before this k's FMAs: loading them ahead by hand
    // changed nothing, PERF.md)
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = lds4(As + kk * 128 + arow(0));
      const float4 a1 = lds4(As + kk * 128 + arow(4));
      const float4 b0 = lds4(Bs + kk * 128 + bcol(0));
      const float4 b1 = lds4(Bs + kk * 128 + bcol(4));
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  } else if constexpr (kBOuter) {
    // A's 8 rows at 4 k's in registers (a float4 a row), then a k at a
    // time B's two float4 and 64 independent FMAs
#pragma unroll
    for (int kh = 0; kh < kBK; kh += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = lds4(As + arow(i) * P + kh);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* br = Bs + (kh + kk) * 128;
        const float4 b0 = lds4(br + bcol(0)), b1 = lds4(br + bcol(4));
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  } else {
    // both along k: A's 8 rows and B's 8 columns at 2 k's in registers
    // (an 8-byte load each), then a k at a time 64 independent FMAs
#pragma unroll
    for (int kh = 0; kh < kBK; kh += 2) {
      float a[8][2], b[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(As + arow(i) * P + kh);
        a[i][0] = v.x; a[i][1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(Bs + bcol(j) * P + kh);
        b[j][0] = v.x; b[j][1] = v.y;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
  }
}

// C = A . B (M x N, depth K), for job 0 (a0, b0, e0) and, where gridDim.z
// is 2 * nsplit, job 1 (a1, b1, e1) of the same shape: block (x, y, z)
// takes job z / nsplit's output tile (n0 = 128x, row tile 128y) over the
// k-tiles z % nsplit, + nsplit, + 2 nsplit, ... that `walk` finds live; its rows are m0 .. m0 + 127, or, in the column tiles
// `order` names (A contiguous along k), the frames at those positions of
// the live-first order. colsum (non-null with B = dg, contiguous along n):
// job 0's blocks of the first row tile store the column sums of the
// staged B tiles, half h = tid / 128 of split s into row 2s + h of
// colsum [2 nsplit][N] (db's partial rows).
template <class A, class B, class Epi>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ring_kernel(A a0, A a1, B b0, B b1, Epi e0, Epi e1, int M, int N, int K,
            int nsplit, Frames walk, LiveRows order,
            float* colsum) {
  constexpr bool kAOuter = A::kFirstContig;
  constexpr bool kBOuter = !B::kFirstContig;
  constexpr int kAF = Stage<kAOuter>::kFloats;
  constexpr int kBF = Stage<kBOuter>::kFloats;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + kStages * kAF;
  __shared__ int rows[kBM];  // the row of each of the tile's 128
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int job = blockIdx.z / nsplit;
  const A a = job ? a1 : a0;
  const B b = job ? b1 : b0;
  const int t_begin = blockIdx.z % nsplit;  // the split
  const auto epi = split_part(job ? e1 : e0, t_begin);
  const int t_end = cdiv(K, kBK);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const bool ordered = !kAOuter && order.lens != nullptr && n0 >= order.n_from;
  bool skip = false;
  static_assert(kThreads >= kBM, "a thread a row of the tile");
  if (tid < kBM) {
    const int j = m0 + tid;
    rows[tid] = j >= M ? -1 : ordered ? order.live_first(j, M / order.T) : j;
  }
  if (ordered) {
    bool live_row = false;
    if (tid < kBM && m0 + tid < M) {
      const int m = rows[tid], bb = m / order.T;
      live_row = m - bb * order.T < __ldg(order.lens + bb);
    }
    skip = !__syncthreads_or(live_row);
  } else {
    __syncthreads();
  }

  // db: column c = tid % 128 of the staged B tiles, over the share of
  // their kBK rows that tid / 128 names
  const bool sums = kBOuter && colsum != nullptr && blockIdx.y == 0 && !job;
  float csum = 0.0f;
  if (!skip) {
    auto next = [&](int t) {
      while (t < t_end && !walk.live(t * kBK)) t += nsplit;
      return t;
    };
    int lt = next(t_begin);  // the next tile to load
    int issued = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (lt < t_end) {
        load_tile<false, kAOuter>(a, As + s * kAF, m0, lt * kBK, rows);
        load_tile<true, kBOuter>(b, Bs + s * kBF, n0, lt * kBK, nullptr);
        lt = next(lt + nsplit);
        ++issued;
      }
      cp_commit();
    }
    for (int i = 0; i < issued; ++i) {
      // tile i has landed, and every thread is done with tile i - 1,
      // whose stage the next load takes
      cp_wait<kStages - 2>();
      __syncthreads();
      if (lt < t_end) {
        const int s = (i + kStages - 1) % kStages;
        load_tile<false, kAOuter>(a, As + s * kAF, m0, lt * kBK, rows);
        load_tile<true, kBOuter>(b, Bs + s * kBF, n0, lt * kBK, nullptr);
        lt = next(lt + nsplit);
        ++issued;
      }
      cp_commit();
      const int s = i % kStages;
      multiply<kAOuter, kBOuter>(As + s * kAF, Bs + s * kBF, acc, tid);
      if constexpr (kBOuter) {
        if (sums) {
          constexpr int kRows = kBK * 128 / kThreads;
          const float* col = Bs + s * kBF + tid / 128 * kRows * 128
                             + tid % 128;
#pragma unroll
          for (int kk = 0; kk < kRows; ++kk) csum += col[kk * 128];
        }
      }
    }
  }
  static_assert(kThreads == 2 * 128, "db: two halves of the 128 columns");
  if (sums && n0 + tid % 128 < N) {
    colsum[(size_t)(2 * t_begin + tid / 128) * N + n0 + tid % 128] = csum;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = rows[row_of<kAOuter>(tid, i)];
    if (m < 0) continue;
    if constexpr (kBOuter) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int n = n0 + col_of<true>(tid, 4 * g);
        if (n < N) {
          epi.four(m, n, make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                     acc[i][4 * g + 2], acc[i][4 * g + 3]),
                   min(4, N - n));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col_of<false>(tid, j);
        if (n < N) epi(m, n, acc[i][j]);
      }
    }
  }
}

namespace {
// The devices (a bit each) on which a kernel's dynamic shared-memory limit
// is raised already. Internal linkage: each library that includes this
// header has its own (a static of an inline function would be one object
// across the libraries, the probes' build variants among them, and a
// variant would then skip its own cudaFuncSetAttribute).
template <class Kernel>
struct SmemRaised {
  static unsigned long long devices;
};
template <class Kernel>
unsigned long long SmemRaised<Kernel>::devices = 0;
}  // namespace

// C = A . B (M x N, depth K) on stream st, its k-tiles dealt to `splits`
// splits (at most the k-tiles; a SplitStore epilogue when there are
// several, whose parts split_sum.cuh then adds); with a1, b1, e1, a second
// job of the same shape in the same launch.
template <class A, class B, class Epi>
cudaError_t launch(A a, B b, Epi epi, int M, int N, int K, int splits,
                   Frames walk, LiveRows order, float* colsum,
                   cudaStream_t st, const A* a1 = nullptr,
                   const B* b1 = nullptr, const Epi* e1 = nullptr) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  const bool two = a1 != nullptr && b1 != nullptr && e1 != nullptr;
  const int ktiles = cdiv(K, kBK);
  const int want = splits > 1 ? splits : 1;
  const int nsplit = want < ktiles ? want : ktiles;
  const dim3 grid(cdiv(N, kBN), cdiv(M, kBM), (two ? 2 : 1) * nsplit);
  constexpr int smem = kStages * sizeof(float) *
      (Stage<A::kFirstContig>::kFloats + Stage<!B::kFirstContig>::kFloats);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  using Raised = SmemRaised<A(B, Epi)>;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(Raised::devices & bit)) {
    e = cudaFuncSetAttribute(ring_kernel<A, B, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    Raised::devices |= bit;
  }
  ring_kernel<A, B, Epi><<<grid, kThreads, smem, st>>>(
      a, two ? *a1 : a, b, two ? *b1 : b, epi, two ? *e1 : epi, M, N, K,
      nsplit, walk, order, colsum);
  return cudaGetLastError();
}

// The SMs of the current device, for splits().
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 132;
  }
  return sms;
}

}  // namespace gemm_f32
