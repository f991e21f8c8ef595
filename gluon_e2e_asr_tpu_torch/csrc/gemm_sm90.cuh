// K1-bwd's bf16 products on Hopper's warpgroup MMA (sm_90a).
//
// Replaces the products that follow the reverse sweep in the TPU kernel
// gluon_e2e_asr_tpu/ops/pallas_lstm.py::_v2_bwd_kernel (:620-643, the
// chunk-merged dot_generals with preferred_element_type=float32). From
// one layer's dg [B,T,8H] f32, as the reverse recurrence writes it (0 at
// t >= lens[b], because K1-fwd's training form masks the activations):
//
//   dx   [B*T, D] = bf16(dg) . bf16(W_x)^T          dx_kernel
//   dW_x [D, 8H]  = bf16(x)^T . bf16(dg)            wgrad_kernel, job 0
//   dW_h [H, 4H]  = bf16(h_prev)^T . bf16(dg_dir)   wgrad_kernel, a job a
//                                                   direction
//
// with f32 sums, and db [8H], the f32 sum of the unrounded dg
// (wgrad_kernel's producers); h_prev is the h stream y [B,T,2H] at t-1
// (forward direction) or t+1 (backward), 0 outside [0, T).
//
// What bounds them on the H100. At the flagship's 4.0 s bucket the three
// do about 300 GFLOP over the live frames (0.30 ms at the 989 TFLOP/s
// bf16 peak), against about 0.8 GB of f32 inputs and outputs: the tensor
// cores, in principle. In practice the operands are f32 in device memory
// and the tensor cores take bf16 from shared memory, so every tile is
// moved from L2 into shared memory in f32 and rounded there: per 2.1
// MFLOP step of a 128 x 128 tile, 48-64 KB from L2 and about 150-210 KB
// through shared memory (the TMA's f32 writes, the rounding's reads and
// bf16 writes, the products' reads), and a chain of barrier hand-offs.
// Those, not the MMA rate, set the time (PERF.md;
// tools/k1b_probe.py --products --ablate).
//
// The design:
//   * Warp specialisation, 640 threads a block, one persistent block an
//     SM (the 227 KB of dynamic shared memory a block may have) walking
//     its share of the output tiles: two producer warpgroups round the
//     staged operands, two consumer warpgroups issue
//     wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators in
//     registers, both operands from shared memory) on their 64 rows of a
//     128 x 128 tile, and one thread of a fifth warpgroup asks the TMA
//     for each step's tiles as soon as their stages are free, so that no
//     other thread ever waits for it (with that thread among the
//     producers instead, every step cost a round of barrier hand-offs
//     between the producer warps, and the products about half as much
//     time again). setmaxnreg moves the TMA warpgroup's registers to the
//     consumers (96 a thread at launch; 40 and 120). The products run
//     on every stage, the epilogue drops what is not wanted: a branch
//     around them makes ptxas serialise them (its C7518).
//   * The rounding, route (a) for the f32 operands: the TMA copies the
//     step's f32 tiles into a staging area (cp.async.bulk.tensor,
//     completion counted in bytes on an mbarrier); the producers round
//     them to bf16 (round to nearest even, __floats2bfloat162_rn) and
//     store them into a ring of bf16 tiles in the 128-byte-swizzled
//     K-major layout that the wgmma descriptors name (row r of 64 bf16 in
//     128 bytes, its 16-byte chunk c at position c ^ (r % 8)), fence the
//     stores for the async proxy and arrive on the stage's full mbarrier;
//     the consumers arrive on its empty mbarrier once their products of
//     it are done. dg, the largest operand and common to all three
//     products, is written by the recurrence in f32, so a bf16 copy would
//     be a separate pass over it. Route (b) for dx's W_x: the wrapper's
//     bf16 copy (6.5 MB at D=1280) goes by TMA in the 128-byte swizzle
//     straight into the ring's B tiles. A transposed operand (x, h_prev
//     and dg in the weight gradients, whose depth is their row index) is
//     read down its staged columns, so the bf16 tiles are always K-major.
//     The weight gradients' producers also sum the staged dg columns for
//     db (the f32 sum of the unrounded dg), in place of a pass of their
//     own over dg: each producer warpgroup its half of a stage's rows, a
//     partial row of its own a split.
//   * Frames in units of 64 of one utterance, (b, t0) with t0 a multiple
//     of 64: the rows of dx and the depth of dW_x and dW_h. The tensor
//     maps are 3-D ([B][T][cols]), so a unit is one box, its rows past T
//     and h_prev's rows at t = -1 and t = T come in as zeros (the TMA's
//     out-of-bounds fill), and the time shift of h_prev is a coordinate.
//     A unit with t0 >= lens[b] holds only zero rows of dg: the weight
//     gradients skip it, and dx writes its rows as 0 without a product
//     (both exact). Every role walks the same list of live units (lens
//     copied into shared memory), so a skipped unit costs neither a
//     stage nor a barrier.
//   * Split-K: the weight gradients' few output tiles (dW_x 200, the two
//     dW_h 60 at the flagship's layer 1) split the unit list into
//     contiguous ranges so that there are about two tiles an SM. Each
//     split stores its whole partial tile (zeros where its range holds no
//     live unit): split 0 into the output, split s > 0 into slice s - 1
//     of a workspace; db's partial rows likewise. split_sum.cuh adds them
//     in the order 0, 1, ..., S - 1 after the launch: no float atomics,
//     the same bits on every run, and no split waits on another inside
//     this persistent kernel. The m-tiles of one (n-tile, split) are
//     neighbouring tiles, and so are
//     dx's n-tiles of one pair of units: the blocks, which take
//     neighbouring tiles at the same time, read the same dg tile together
//     and find it in L2.
//   * Ragged edges: boxes past an operand's columns are zero-filled and
//     the epilogue masks rows and columns past the output (dW_x's 80 rows
//     at layer 0, dx's 80 columns); dW_h's rows past H read the other
//     direction's columns or zeros, and are masked.
//   * Tensor maps are encoded per call through the driver's
//     cuTensorMapEncodeTiled, found with dlsym in libcuda.so.1 (which the
//     CUDA runtime has loaded). Their row strides, and the start of a box
//     along a row, must be multiples of 16 bytes: the wrapper pads x's
//     rows and lays y out with each direction's h on a 16-byte boundary
//     (yb, the backward direction's first column) where a shape needs it,
//     never at the configs' shapes. A map the driver refuses returns
//     kNoTensorMap.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"
#include "split_sum.cuh"

namespace gemm_sm90 {

using namespace sm90;  // the PTX helpers

constexpr int kBM = 128;        // output rows a block, 64 a consumer
constexpr int kBN = 128;        // output columns a block
constexpr int kBK = 64;         // depth of a stage: one 128-byte bf16 row
constexpr int kUnit = 64;       // frames of a unit (b, t0)
constexpr int kProducers = 2;   // producer (converter) warpgroups
constexpr int kProducerThreads = 128 * kProducers;
// the producers, two consumer warpgroups and the TMA warpgroup (one
// thread of it works; setmaxnreg wants whole warpgroups)
constexpr int kThreads = kProducerThreads + 256 + 128;
// Registers a thread at launch (65,536 over the threads, rounded down to
// 8): 96; the TMA warpgroup (40 hold its walk without a spill) gives 56
// of its to the consumers' 24.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kTmaRegs = 40;
constexpr int kConsumerRegs = kLaunchRegs + 24;
static_assert(kThreads % 128 == 0, "setmaxnreg wants whole warpgroups");
static_assert((kLaunchRegs - kTmaRegs) * 128 >= (kConsumerRegs - kLaunchRegs) * 256,
              "the consumers take more registers than the TMA warpgroup gives");
constexpr int kTileBytes = kBM * kBK * 2;   // a bf16 operand tile
constexpr int kF32Tile = kBM * kBK * 4;     // an f32 operand tile
constexpr int kMaxSmem = 232448;            // a block's, on the H100
constexpr int kNoTensorMap = -2;
static_assert(kBM == kBN && kBK == kUnit, "the converters assume square tiles");

// Each kernel's ring: kStages stages of bf16 A and B tiles, and a
// staging area of kStaging stages of kStagedBytes of f32 as the TMA left
// them. dx stages dg alone (W_x comes in bf16 straight into the ring's B
// tiles): 4 stages and 3 staging stages; the weight gradients stage both
// operands: 3 and 2.
template <int kStagedBytes_, int kStaging_, int kStages_>
struct Ring {
  static constexpr int kStagedBytes = kStagedBytes_;
  static constexpr int kStaging = kStaging_;
  static constexpr int kStages = kStages_;
  static constexpr int kBarBytes = 8 * (2 * kStages + 2 * kStaging);
  static constexpr int kFixed = 2 * kStages * kTileBytes
      + kStaging * kStagedBytes + kBarBytes + 1024 /* alignment */;
  // lens in shared memory for B up to kMaxLens (else read from global)
  static constexpr int kMaxLens = (kMaxSmem - kFixed) / 4;
  static constexpr int kSmemBytes = kMaxSmem;
  static_assert(kMaxLens >= 96, "no room for the flagship's lens");
};
using DxRing = Ring<2 * kUnit * kBK * 4, 3, 4>;  // 4 x 32 KB, 3 x 32 KB
using WgradRing = Ring<2 * kF32Tile, 2, 3>;      // 3 x 32 KB, 2 x 64 KB

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], both K-major in shared memory.
// Thread l of warp w of the warpgroup holds rows 16w + l/4 (+ 8) and
// columns 8j + 2(l % 4) (+ 1): d[4j + 2h + e] is (16w + l/4 + 8h,
// 8j + 2(l % 4) + e).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// Shared memory, the ring and its barriers
// ---------------------------------------------------------------------------

// The ring (R::kStages bf16 A and B tiles, full and empty barriers), the
// staging area (R::kStaging f32 stages, sfull and sempty barriers) and
// the rows' lengths.
template <class R>
struct Smem {
  uint8_t* base;          // 1024-byte aligned
  uint64_t* full;         // [R::kStages] the producer's 4 warps arrive
                          // (and dx's W_x tile counts its bytes)
  uint64_t* empty;        // [R::kStages] the consumers' 8 warps arrive
  uint64_t* sfull;        // [kStaging] the TMA's bytes
  uint64_t* sempty;       // [kStaging] the producer's 4 warps arrive
  int* lens;              // [B] when B <= R::kMaxLens
  // bf16 A tiles [128 rows][64 k] and B tiles [128 cols][64 k], swizzled
  __device__ __forceinline__ uint8_t* a(int i) const { return base + i * kTileBytes; }
  __device__ __forceinline__ uint8_t* b(int i) const {
    return base + (R::kStages + i) * kTileBytes;
  }
  __device__ __forceinline__ float* staged(int i) const {
    return reinterpret_cast<float*>(base + 2 * R::kStages * kTileBytes
                                    + i * R::kStagedBytes);
  }
};

// Carves the dynamic shared memory, initialises the barriers and copies
// lens in (where B fits); returns where lens are to be read.
template <class R>
__device__ __forceinline__ Smem<R> setup(uint8_t* raw, const int* lens, int B) {
  Smem<R> s;
  s.base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      s.base + 2 * R::kStages * kTileBytes + R::kStaging * R::kStagedBytes);
  s.full = bars;
  s.empty = bars + R::kStages;
  s.sfull = bars + 2 * R::kStages;
  s.sempty = bars + 2 * R::kStages + R::kStaging;
  s.lens = reinterpret_cast<int*>(bars + 2 * R::kStages + 2 * R::kStaging);
  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      mbar_init(s.full + i, 4 * kProducers);
      mbar_init(s.empty + i, 8);
    }
    for (int i = 0; i < R::kStaging; ++i) {
      mbar_init(s.sfull + i, 1);
      mbar_init(s.sempty + i, 4 * kProducers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (B <= R::kMaxLens) {
    for (int i = threadIdx.x; i < B; i += blockDim.x) s.lens[i] = lens[i];
  } else {
    s.lens = const_cast<int*>(lens);
  }
  __syncthreads();
  return s;
}

// f32 [128 rows][64 k] (K contiguous, as boxes {64, 64}) -> a bf16
// tile. Producer thread p takes chunk c = p % 8 of rows R i + p / 8
// (R = kProducerThreads / 8 rows a pass): the 8 lanes of a 16-byte access
// phase read one row, the first half of their chunks alternating with
// the second so that the phase spreads over all 32 banks, and store 8
// distinct chunk positions of one row.
__device__ __forceinline__ void convert_k(const float* src, uint8_t* dst,
                                          int p) {
  constexpr int kRows = kProducerThreads / 8;
  const int c = p & 7, h = (c >> 2) & 1;
#pragma unroll 2
  for (int i = 0; i < kBM / kRows; ++i) {
    const int r = i * kRows + (p >> 3);
    const float* s = src + r * kBK + c * 8;
    const float4 first = *reinterpret_cast<const float4*>(s + 4 * h);
    const float4 second = *reinterpret_cast<const float4*>(s + 4 * (h ^ 1));
    const float4 lo = h ? second : first, hi = h ? first : second;
    *reinterpret_cast<uint4*>(dst + sw128_at(r, c)) = make_uint4(
        pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
        pack_bf16(hi.z, hi.w));
  }
}

// f32 [64 k][128 cols] (the operand's row index is the depth, as a box
// {128, 64}) -> a bf16 tile [128 cols][64 k]. Producer thread p takes
// column p % 128 and its chunks of the producer warpgroup p / 128: each
// of its reads walks down a column, a warp's 32 lanes reading 32
// consecutive words, and its chunk stores land on 8 distinct positions
// for any 8 consecutive lanes. Returns the f32 sum of its part of the
// column.
__device__ __forceinline__ float convert_mn(const float* src, uint8_t* dst,
                                           int p) {
  constexpr int kChunks = kBK / 8 / kProducers;
  const int col = p % kBM, c0 = p / kBM * kChunks;
  float sum = 0.0f;
#pragma unroll 2
  for (int c = c0; c < c0 + kChunks; ++c) {
    const float* s = src + c * 8 * kBM + col;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = s[e * kBM];
      sum += v[e];
    }
    *reinterpret_cast<uint4*>(dst + sw128_at(col, c)) = make_uint4(
        pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
        pack_bf16(v[6], v[7]));
  }
  return sum;
}

// ---------------------------------------------------------------------------
// The pipeline
// ---------------------------------------------------------------------------

// The kernels are persistent: block b takes the tiles b, b + G, b + 2G,
// ... (G = gridDim.x, one block an SM), so that at any time the blocks
// work on neighbouring tiles, and the ring's stages and phases run on
// from one tile to the next (the producer loads the next tile while the
// consumers store the last). A plan describes the tiles: tile(t) decodes
// tile t; its live steps are next(x, first(x)), next(x, step + 1), ...
// while below end(x); issue(x, step, staged, b_tile, sfull, full) asks
// the TMA for a step's tiles; convert(x, staged, a, b, p) rounds them into
// the ring; finish(x, p) closes a tile on the producer's side.

// A block's position in its walk over (tile, live step).
template <class Plan>
struct Walk {
  const Plan& plan;
  int t;  // the tile; plan.tiles or more at the end
  typename Plan::Tile x;
  int step;
  __device__ explicit Walk(const Plan& p) : plan(p), t(blockIdx.x) { enter(); }
  __device__ bool done() const { return t >= plan.tiles; }
  // Moves to the next live step; true when that leaves the tile.
  __device__ bool advance() {
    step = plan.next(x, step + 1);
    if (step < plan.end(x)) return false;
    t += gridDim.x;
    enter();
    return true;
  }

 private:
  // the first live step of tile t or of the block's next tile with one
  __device__ void enter() {
    for (; t < plan.tiles; t += gridDim.x) {
      x = plan.tile(t);
      step = plan.next(x, plan.first(x));
      if (step < plan.end(x)) return;
    }
  }
};

// The TMA warp (its lane 0): asks for each step's tiles as soon as the
// step's staging stage (and, for a B tile the TMA writes, its ring slot)
// is free, so that no converter ever waits for it to do anything but
// land the bytes.
template <class R, class Plan>
__device__ __forceinline__ void issue(const Smem<R>& s, const Plan& plan) {
  int j = 0;
  for (Walk<Plan> w(plan); !w.done(); w.advance(), ++j) {
    const int k = j % R::kStaging, st = j % R::kStages;
    mbar_wait(s.sempty + k, ((j / R::kStaging) & 1) ^ 1);
    if (Plan::kRingB) mbar_wait(s.empty + st, ((j / R::kStages) & 1) ^ 1);
    plan.issue(w.x, w.step, s.staged(k), s.b(st), s.sfull + k, s.full + st);
  }
}

// The producer warpgroups: round each staged step into the ring; finish a
// tile on their side when the walk leaves it.
template <class R, class Plan>
__device__ __forceinline__ void produce(const Smem<R>& s, const Plan& plan) {
  const int p = threadIdx.x;
  int i = 0;
  Walk<Plan> w(plan);
  while (!w.done()) {
    const int k = i % R::kStaging, st = i % R::kStages;
    mbar_wait(s.sfull + k, (i / R::kStaging) & 1);
    mbar_wait(s.empty + st, ((i / R::kStages) & 1) ^ 1);
    plan.convert(w.x, s.staged(k), s.a(st), s.b(st), p);
    fence_proxy_async();
    __syncwarp();
    if ((p & 31) == 0) {
      mbar_arrive(s.full + st);
      mbar_arrive(s.sempty + k);
    }
    ++i;
    const typename Plan::Tile x = w.x;
    if (w.advance()) plan.finish(x, p);
  }
}

// A consumer warpgroup (wg 0 or 1: rows 64 wg .. 64 wg + 63 of the A
// tiles), tile by tile: four k16 products a stage, one group in flight,
// the stage before released once its group is done; then
// epilogue(tile, steps, acc). The products run on every
// stage, also for rows the epilogue drops: no branch around them.
template <class R, class Plan, class Epilogue>
__device__ __forceinline__ void consume(const Smem<R>& s, const Plan& plan,
                                        int wg, Epilogue epilogue) {
  const bool leader = (threadIdx.x & 31) == 0;
  float acc[64];
  int i = 0;
  for (int t = blockIdx.x; t < plan.tiles; t += gridDim.x) {
    const typename Plan::Tile x = plan.tile(t);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    int n = 0;
    for (int step = plan.next(x, plan.first(x)); step < plan.end(x);
         step = plan.next(x, step + 1), ++i, ++n) {
      const int st = i % R::kStages;
      mbar_wait(s.full + st, (i / R::kStages) & 1);
      const uint64_t da = sw128_desc(s.a(st) + wg * 64 * 128);
      const uint64_t db = sw128_desc(s.b(st));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (n > 0 && leader) mbar_arrive(s.empty + (i - 1) % R::kStages);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (n > 0 && leader) mbar_arrive(s.empty + (i - 1) % R::kStages);
    epilogue(x, n, acc);
  }
}

// ---------------------------------------------------------------------------
// dx [B*T, D] = dg . W_x^T
// ---------------------------------------------------------------------------

// Tile t: the units 2q and 2q + 1 (one a consumer) and the 128 columns
// n0, q = t / ntiles; its steps run over the depth 8H. dg_map: dg as
// [B][T][8H] f32, box {64, 64, 1}, staged and rounded; wx_map: W_x's
// bf16 copy as [1][D][8H], box {64, 128, 1} in the 128-byte swizzle,
// straight into the ring's B tile.
struct DxPlan {
  static constexpr bool kRingB = true;  // the TMA writes the B tiles
  const CUtensorMap* dg_map;
  const CUtensorMap* wx_map;
  const int* lens;
  int B, T, D, K8, U, ntiles, tiles;
  struct Tile {
    int b0, t00, b1, t01, n0;
    bool valid0, valid1, live0, live1;
  };
  __device__ Tile tile(int t) const {
    Tile x;
    const int q = t / ntiles;
    x.n0 = (t % ntiles) * kBN;
    x.valid0 = 2 * q < B * U;
    x.valid1 = 2 * q + 1 < B * U;
    x.b0 = x.valid0 ? 2 * q / U : 0;
    x.b1 = x.valid1 ? (2 * q + 1) / U : 0;
    x.t00 = (2 * q % U) * kUnit;
    x.t01 = ((2 * q + 1) % U) * kUnit;
    x.live0 = x.valid0 && x.t00 < lens[x.b0];
    x.live1 = x.valid1 && x.t01 < lens[x.b1];
    return x;
  }
  __device__ int first(const Tile&) const { return 0; }
  __device__ int next(const Tile&, int k) const { return k; }
  __device__ int end(const Tile& x) const {
    return (x.live0 || x.live1) ? (K8 + kBK - 1) / kBK : 0;
  }
  __device__ void issue(const Tile& x, int k, float* staged, uint8_t* b,
                        uint64_t* sfull, uint64_t* full) const {
    mbar_expect_bytes(full, kTileBytes);
    tma_load(b, wx_map, full, k * kBK, x.n0, 0);
    mbar_expect_tx(sfull, (x.live0 + x.live1) * kUnit * kBK * 4);
    if (x.live0) tma_load(staged, dg_map, sfull, k * kBK, x.t00, x.b0);
    if (x.live1) tma_load(staged + kUnit * kBK, dg_map, sfull, k * kBK, x.t01, x.b1);
  }
  __device__ void convert(const Tile&, const float* staged, uint8_t* a,
                          uint8_t*, int p) const {
    convert_k(staged, a, p);
  }
  __device__ void finish(const Tile&, int) const {}
};

__global__ void __launch_bounds__(kThreads, 1)
dx_kernel(const __grid_constant__ CUtensorMap dg_map,
          const __grid_constant__ CUtensorMap wx_map,
          const int* __restrict__ lens, float* __restrict__ dx, int B, int T,
          int D, int K8) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<DxRing> s = setup<DxRing>(smem_raw, lens, B);
  const int U = (T + kUnit - 1) / kUnit, ntiles = (D + kBN - 1) / kBN;
  const DxPlan plan{&dg_map, &wx_map, s.lens, B, T, D, K8, U, ntiles,
                    (B * U + 1) / 2 * ntiles};
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kProducers + 2) {  // the TMA warpgroup
    setmaxnreg_dec<kTmaRegs>();
    if (threadIdx.x == kThreads - 128) issue(s, plan);
  } else if (wg < kProducers) {
    produce(s, plan);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - kProducers;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const bool pairs = (D & 1) == 0;
    consume(s, plan, w, [&](const DxPlan::Tile& x, int, float (&acc)[64]) {
      if (!(w ? x.valid1 : x.valid0)) return;
      // A dead unit stores zeros; a live unit's rows at t >= lens[b] are
      // exact zeros of the product (dg is 0 there).
      const bool live = w ? x.live1 : x.live0;
      const int b = w ? x.b1 : x.b0, t0 = w ? x.t01 : x.t00;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + warp * 16 + (lane >> 2) + 8 * h;
        if (t >= T) continue;
        float* row = dx + ((size_t)b * T + t) * D;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int n = x.n0 + 8 * j + 2 * (lane & 3);
          const float v0 = live ? acc[4 * j + 2 * h] : 0.0f;
          const float v1 = live ? acc[4 * j + 2 * h + 1] : 0.0f;
          if (pairs && n + 1 < D) {
            *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
          } else {
            if (n < D) row[n] = v0;
            if (n + 1 < D) row[n + 1] = v1;
          }
        }
      }
    });
  }
}

// ---------------------------------------------------------------------------
// dW_x and dW_h: out[M, N] = A^T . dg, a split's part over its live units
// ---------------------------------------------------------------------------

struct Job {
  float* out;           // [M, N], split 0's part
  float* ws;            // split s > 0's part at ws + (s - 1) * slice
  long long slice;
  int M, N;
  int a_from_y;         // A is h_prev (the y map), else x (the x map)
  int a_col0, a_shift;  // A's first column in its map; its frame shift
  int b_col0;           // the first dg column
  int mt, nt, first;    // m-tiles, n-tiles, first tile
};

struct WgradArgs {
  Job job[3];
  int njobs, splits, tiles;
  const int* lens;
  float* db;            // db's partial rows [splits][kProducers][8H] (job
                        // 0's first m-tile), or null
  int B, T;
};

// Tile t: job j, m-tile (fastest), n-tile, split; its steps are the live
// units of the split. x_map: x as [B][T][D], y_map: y as [B][T][ldy],
// dg_map: dg as [B][T][8H], each f32, box {128, 64, 1}, both operands
// staged and rounded. The producer's threads, which read every staged dg
// column, also sum them for db (job 0's first m-tile only: the f32 sum
// of the unrounded dg), each into its split's and warpgroup's partial
// row; a tile with no live unit, which the producers never see, has its
// partial rows zeroed by the consumers.
struct WgradPlan {
  static constexpr bool kRingB = false;
  const CUtensorMap* x_map;
  const CUtensorMap* y_map;
  const CUtensorMap* dg_map;
  const WgradArgs* args;
  const int* lens;
  int U, units, tiles;
  struct Tile {
    float* out;  // the split's part of the output
    int M, N, m0, n0, a_col, a_shift, b_col, begin, end, split;
    bool a_from_y, db;
  };
  __device__ Tile tile(int t) const {
    const WgradArgs& a = *args;
    const Job& j = (a.njobs > 2 && t >= a.job[2].first) ? a.job[2]
                 : (a.njobs > 1 && t >= a.job[1].first) ? a.job[1]
                 : a.job[0];
    Tile x;
    int local = t - j.first;
    x.m0 = (local % j.mt) * kBM;
    local /= j.mt;
    x.n0 = (local % j.nt) * kBN;
    const int split = local / j.nt;
    x.begin = (int)((long long)split * units / a.splits);
    x.end = (int)((long long)(split + 1) * units / a.splits);
    x.split = split;
    x.out = split == 0 ? j.out : j.ws + (split - 1) * j.slice;
    x.M = j.M;
    x.N = j.N;
    x.a_from_y = j.a_from_y != 0;
    x.a_col = j.a_col0 + x.m0;
    x.a_shift = j.a_shift;
    x.b_col = j.b_col0 + x.n0;
    x.db = a.db != nullptr && t < a.job[0].first + a.job[0].mt * a.job[0].nt
           * a.splits && x.m0 == 0;
    return x;
  }
  __device__ int first(const Tile& x) const { return x.begin; }
  __device__ int end(const Tile& x) const { return x.end; }
  // the first live unit at or after u
  __device__ int next(const Tile& x, int u) const {
    while (u < x.end && (u % U) * kUnit >= lens[u / U]) ++u;
    return u;
  }
  __device__ void issue(const Tile& x, int u, float* staged, uint8_t*,
                        uint64_t* sfull, uint64_t*) const {
    const int b = u / U, t0 = (u % U) * kUnit;
    mbar_expect_tx(sfull, 2 * kF32Tile);
    tma_load(staged, x.a_from_y ? y_map : x_map, sfull, x.a_col,
             t0 + x.a_shift, b);
    tma_load(staged + kF32Tile / 4, dg_map, sfull, x.b_col, t0, b);
  }
  // The running column sum of dg (thread p's column) over a db tile.
  mutable float col = 0.0f;
  __device__ void convert(const Tile& x, const float* staged, uint8_t* a,
                          uint8_t* b, int p) const {
    convert_mn(staged, a, p);
    const float s = convert_mn(staged + kF32Tile / 4, b, p);
    if (x.db) col += s;
  }
  __device__ void finish(const Tile& x, int p) const {
    const int n = x.n0 + p % kBM;
    if (x.db && n < x.N) {
      args->db[(size_t)(x.split * kProducers + p / kBM) * x.N + n] = col;
    }
    col = 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap y_map,
             const __grid_constant__ CUtensorMap dg_map,
             const __grid_constant__ WgradArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<WgradRing> s = setup<WgradRing>(smem_raw, args.lens, args.B);
  const int U = (args.T + kUnit - 1) / kUnit;
  const WgradPlan plan{&x_map, &y_map, &dg_map, &args, s.lens, U,
                       args.B * U, args.tiles};
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kProducers + 2) {  // the TMA warpgroup
    setmaxnreg_dec<kTmaRegs>();
    if (threadIdx.x == kThreads - 128) issue(s, plan);
  } else if (wg < kProducers) {
    produce(s, plan);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - kProducers;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    static_assert(kProducers == 2, "a consumer warpgroup a producer's db row");
    consume(s, plan, w, [&](const WgradPlan::Tile& x, int steps,
                            float (&acc)[64]) {
      if (steps == 0 && x.db) {  // no producer saw the tile
        const int n = x.n0 + threadIdx.x % 128;
        if (n < x.N) {
          args.db[(size_t)(x.split * kProducers + w) * x.N + n] = 0.0f;
        }
      }
      // every tile stores its part, zeros where it had no live unit
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = x.m0 + 64 * w + warp * 16 + (lane >> 2) + 8 * h;
        if (m >= x.M) continue;
        float* row = x.out + (size_t)m * x.N;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int n = x.n0 + 8 * j + 2 * (lane & 3);
          // N is even (8H, 4H) and slices start 16-byte aligned, so a
          // pair is 8-byte aligned
          if (n < x.N) {
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    });
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// [d2][d1][d0] of f32 (or, with bf16, of bf16 in the 128-byte swizzle),
// rows of ld elements, boxes {box0, box1, 1}; out of bounds reads as 0.
inline bool make_map(CUtensorMap* map, const void* p, int d0, int d1, int d2,
                     int ld, int box0, int box1, bool bf16 = false) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t size = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * size, (cuuint64_t)ld * d1 * size};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dx [B*T, D] = dg [B*T, 8H] . W_x^T from W_x's bf16 copy wx16 [D, 8H];
// every row written.
inline int launch_dx(const float* dg, const __nv_bfloat16* wx16,
                     const int* lens, float* dx, int B, int T, int D, int H,
                     cudaStream_t st) {
  CUtensorMap dg_map, wx_map;
  const int K8 = 8 * H;
  if (!make_map(&dg_map, dg, K8, T, B, K8, kBK, kUnit) ||
      !make_map(&wx_map, wx16, K8, D, 1, K8, kBK, kBN, true)) {
    return kNoTensorMap;
  }
  cudaError_t e = cudaFuncSetAttribute(
      dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DxRing::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int U = (T + kUnit - 1) / kUnit;
  const int tiles = (B * U + 1) / 2 * ((D + kBN - 1) / kBN);
  const int sms = num_sms(), blocks = tiles < sms ? tiles : sms;
  dx_kernel<<<blocks, kThreads, DxRing::kSmemBytes, st>>>(dg_map, wx_map, lens,
                                                          dx, B, T, D, K8);
  return (int)cudaGetLastError();
}

// Splits of the unit list: about two tiles an SM over all jobs, at least
// 16 units a split.
inline int wgrad_splits(int tiles, int units, int sms) {
  const int want = (2 * sms + tiles - 1) / tiles;
  const int most = units / 16 > 1 ? units / 16 : 1;
  return want < most ? want : most;
}

// The weight gradients' split plan: dW_x (with x) and both dW_h over the
// B*ceil(T/64) units. *splits gets the splits; returns the floats of the
// workspace their parts take: each job's S - 1 slices (split_sum::slice
// of its M*N), then, with x, db's kProducers * S partial rows of 8H.
inline long long wgrad_workspace(int B, int T, int D, int H, bool with_x,
                                 int sms, int* splits) {
  const auto tiles = [](int M, int N) {
    return ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  };
  const int units = B * ((T + kUnit - 1) / kUnit);
  const int S = wgrad_splits((with_x ? tiles(D, 8 * H) : 0)
                             + 2 * tiles(H, 4 * H), units, sms);
  *splits = S;
  long long f = 2 * (S - 1) * split_sum::slice((long long)H * 4 * H);
  if (with_x) {
    f += (S - 1) * split_sum::slice((long long)D * 8 * H)
         + (long long)kProducers * S * 8 * H;
  }
  return f;
}

// dW_x [D, 8H] and db [8H] (when x is given) and dW_h of both directions
// [H, 4H], every element written: wgrad_kernel's parts, then their sum
// by split_sum_kernel. x [B,T,D] with rows of ldx floats; y [B,T,*] with
// rows of ldy floats, the forward direction's h at columns 0 .. H, the
// backward direction's at yb .. yb + H (ldx, ldy and yb multiples of 4);
// dg [B,T,8H]; ws the workspace of wgrad_workspace's floats (16-byte
// aligned).
inline int launch_wgrad(const float* x, int ldx, int D, const float* y,
                        int ldy, int yb, const float* dg, const int* lens,
                        float* dwx, float* db, float* dwhf, float* dwhb, int B,
                        int T, int H, float* ws, cudaStream_t st) {
  CUtensorMap x_map{}, y_map, dg_map;
  if ((x != nullptr && !make_map(&x_map, x, D, T, B, ldx, kBM, kUnit)) ||
      !make_map(&y_map, y, ldy, T, B, ldy, kBM, kUnit) ||
      !make_map(&dg_map, dg, 8 * H, T, B, 8 * H, kBN, kUnit)) {
    return kNoTensorMap;
  }
  const int sms = num_sms();
  int splits = 1;
  wgrad_workspace(B, T, D, H, x != nullptr, sms, &splits);
  WgradArgs args{};
  int n = 0;
  auto add = [&](float* out, int M, int N, int from_y, int a_col0, int shift,
                 int b_col0) {
    Job& j = args.job[n++];
    j.out = out;
    j.slice = split_sum::slice((long long)M * N);
    j.ws = ws;
    ws += (splits - 1) * j.slice;
    j.M = M;
    j.N = N;
    j.a_from_y = from_y;
    j.a_col0 = a_col0;
    j.a_shift = shift;
    j.b_col0 = b_col0;
    j.mt = (M + kBM - 1) / kBM;
    j.nt = (N + kBN - 1) / kBN;
  };
  if (x != nullptr) add(dwx, D, 8 * H, 0, 0, 0, 0);
  add(dwhf, H, 4 * H, 1, 0, -1, 0);       // h_prev = y at t - 1
  add(dwhb, H, 4 * H, 1, yb, +1, 4 * H);  // h_prev = y at t + 1
  args.njobs = n;
  args.splits = splits;
  args.lens = lens;
  args.db = x != nullptr ? ws : nullptr;  // after the jobs' slices
  args.B = B;
  args.T = T;
  args.tiles = 0;
  for (int i = 0; i < n; ++i) {
    args.job[i].first = args.tiles;
    args.tiles += args.job[i].mt * args.job[i].nt * args.splits;
  }
  const int blocks = args.tiles < sms ? args.tiles : sms;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WgradRing::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<<<blocks, kThreads, WgradRing::kSmemBytes, st>>>(x_map, y_map,
                                                               dg_map, args);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  split_sum::Seg segs[4];
  for (int i = 0; i < n; ++i) {
    const Job& j = args.job[i];
    segs[i] = {j.out, j.ws, (long long)j.M * j.N, j.slice, splits - 1, 1};
  }
  const int N8 = 8 * H;
  segs[n] = {db, args.db, x != nullptr ? N8 : 0, N8, kProducers * splits, 0};
  return (int)split_sum::launch(segs, n + 1, sms, st);
}

}  // namespace gemm_sm90
