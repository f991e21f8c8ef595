// K1-fwd's bf16 projection on Hopper's warpgroup MMA (sm_90a).
//
// Replaces the projection inside the TPU kernel
// gluon_e2e_asr_tpu/ops/pallas_lstm.py::_v2_fwd_kernel (:426-437, the
// dot_general of x and W_x with preferred_element_type=float32, the bias
// and the backward half masked past each row's length). For one layer,
// M = B*T rows, depth D, N = 8H columns:
//
//   xg[m, n] = sum_k bf16(x[m, k]) . bf16(W_x[k, n]) + b_x[n]   (f32 sums)
//   xg[m, n] = 0 for n >= 4H where t = m % T >= lens[m / T]
//   with round_xg, every value rounded to bf16 (stored as f32)
//
// Every row is written, the forward half past lens included. xg stays
// f32: the training form overwrites it in place with the gate
// activations.
//
// What bounds it on the H100. At the flagship's 4.0 s bucket the three
// layers do about 0.2 TFLOP (0.21 ms at the 989 TFLOP/s bf16 peak) and
// move about 0.86 GB: x in (f32, 159 MB), W_x's bf16 copies (13 MB) and
// xg out (f32, 685 MB), 0.25 ms at 3.35 TB/s. So the f32 xg write is
// the floor, the products next; and every step of a tile reads its x
// rows (f32) and a W_x tile (bf16) from L2. Measured on the H100
// (PERF.md; tools/k1f_probe.py --proj --ablate): the first layer (D=80)
// runs at about three quarters of its byte floor, the xg stores most of
// its time; at D=1280 no single piece sets the pace: without the
// products, the rounding or the stores it runs at most 10% faster,
// without the x or the W_x loads 10-15%, and a ring of 2 stages, or of 6
// stages of 32 k, costs 5-15% more.
//
// The design:
//   * One persistent block an SM (384 threads, 230 KB of dynamic shared
//     memory) walks tiles of 128 rows x 256 columns, the columns
//     fastest, so the blocks working at one time share their x rows in
//     L2 (N = 2560 at the flagship is ten such tiles). Warp
//     specialisation: one thread of a TMA warpgroup asks for each
//     step's operands as soon as their stage of the ring is free (kStages
//     stages of 64 k); two consumer warpgroups, 64 rows each, issue
//     wgmma.mma_async m64n256k16 with f32 accumulators in registers (128
//     a thread). setmaxnreg moves the TMA warpgroup's registers to the
//     consumers (168 a thread at launch; 40 and 232).
//   * x is rounded by the consumers, in registers: the TMA stages x's
//     f32 tile in the 128-byte swizzle (two boxes of 32 floats a row),
//     each consumer reads its rows' k16 slice straight into the register
//     fragment of wgmma's A-from-registers form (four 8-byte reads a
//     thread), rounds it with cvt.rn.bf16x2.f32 (round to nearest even,
//     as __floats2bfloat162_rn) and issues the product with B from
//     shared memory. The fragment is double-buffered: the next slice is
//     read and rounded while the current product runs. There is no bf16
//     copy of x and no pass through shared memory to round it: a staged
//     f32 operand rounded by converter warpgroups into a bf16 ring held
//     K1-bwd's products (gemm_sm90.cuh) to 14% of their bound (PERF.md).
//   * Fragment row g of a warp's 8-row group reads the tile's row
//     row_of(g) = 2g % 8 + g / 4 of that group (and the epilogue writes
//     it there): under the swizzle, the 16 lanes of a half-warp then
//     read 16 distinct 8-byte words of the 32 banks (fragment row g
//     itself would put two rows on each pair of 16-byte chunks). The
//     products sum over k alone, so permuting rows changes nothing else.
//   * W_x goes over in bf16 by TMA straight into the ring's B tiles: a
//     per-call copy that wt_kernel rounds and lays out K-major as W_x^T
//     [8H][ldw] (ldw = D rounded up to 8, the padding zeros), so that its
//     tile is the K-major, 128-byte swizzled layout the wgmma descriptor
//     names, as dx_kernel's W_x (the transposed-B form would read W_x's
//     own layout, but the copy is needed for the rounding anyway). It
//     transposes through shared memory, both sides coalesced: 6.5 MB
//     written at D=1280.
//   * Ragged edges: boxes past D, M or N come in as the TMA's zeros; the
//     epilogue's TMA store clips rows past M and columns past N. A box
//     starts on a 16-byte boundary along a row: x's rows are padded to a
//     multiple of 4 floats by the wrapper where D needs it.
//   * The epilogue, asynchronous TMA stores: each consumer adds the bias,
//     masks the backward half of its rows past lens (b = m / T once a
//     row), applies round_xg and writes its 64 x 256 result 32 columns at
//     a time into one of two swizzled staging buffers, from which the
//     TMA stores it (cp.async.bulk.tensor, bulk groups); the consumer
//     goes on to the next tile's products while the stores drain, and
//     waits only before it reuses a buffer. The products run on every
//     stage with no data-dependent branch around them (a branch makes
//     ptxas serialise them, its C7518).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

// 0 waits for a tile's stores to complete before the next tile (the
// epilogue not overlapped): a build variant that tools/k1f_probe.py
// --proj --ablate times.
#define PROJ_OVERLAP_EPILOGUE 1

namespace proj_sm90 {

using namespace sm90;  // the PTX helpers

constexpr int kBM = 128;          // rows of a tile, 64 a consumer
constexpr int kBN = 256;          // columns of a tile (m64n256k16)
constexpr int kBK = 64;           // depth of a stage
constexpr int kBox = 32;          // floats of an x box along a row (128 B)
constexpr int kOutCols = 32;      // columns of an epilogue store box
constexpr int kStages = 3;        // the ring
constexpr int kThreads = 384;     // two consumer warpgroups, the TMA's
// Registers a thread at launch (65,536 over the threads, rounded down to
// 8): 168; the TMA warpgroup keeps 40 and gives the rest to the
// consumers' 232.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kTmaRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert((kLaunchRegs - kTmaRegs) * 128 >= (kConsumerRegs - kLaunchRegs) * 256,
              "the consumers take more registers than the TMA warpgroup gives");
constexpr int kABoxBytes = kBM * kBox * 4;      // 16 KB, one x box
constexpr int kABoxes = kBK / kBox;             // x boxes a stage
constexpr int kBRow = kBK * 2;                  // bytes of a W_x tile's row
constexpr int kBBytes = kBN * kBRow;            // 32 KB, a W_x tile
constexpr int kStageBytes = kABoxes * kABoxBytes + kBBytes;
static_assert(kBK % kBox == 0 && (kBRow == 64 || kBRow == 128),
              "a stage is whole x boxes, and W_x's rows one swizzle span");
constexpr int kOutBytes = 64 * kOutCols * 4;    // 8 KB, a staging buffer
constexpr int kSmemBytes = kStages * kStageBytes + 4 * kOutBytes
    + 8 * 2 * kStages + 1024 /* alignment */;
static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
constexpr int kNoTensorMap = -2;

// The tile's row that fragment row g (0..7) of an 8-row group reads and
// writes: 0 2 4 6 1 3 5 7 (see the header).
__device__ __forceinline__ int row_of(int g) { return (2 * g) % 8 + g / 4; }

// Descriptor of a K-major bf16 W_x tile, rows of kBRow bytes in the swizzle
// of that span (64 or 128 bytes; the TMA's of the same name): 8-row groups
// 8 kBRow bytes apart (SBO), the leading offset unused. The tile starts
// 1024-byte aligned (swizzle phase 0); one k16 step further is 32 bytes,
// 2 in the address field.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;                      // leading byte offset, unused
  d |= uint64_t(8 * kBRow >> 4) << 32;         // stride byte offset
  d |= uint64_t(kBRow == 128 ? 1 : 2) << 62;   // 128- or 64-byte swizzle
  return d;
}

// ---------------------------------------------------------------------------
// PTX of this kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most kPending bulk groups still read shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending) : "memory");
}

// Waits until at most kPending bulk groups are incomplete (their writes
// done).
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" :: "n"(kPending) : "memory");
}

// A consumer warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A from registers (a: the
// warpgroup's fragment, see load_slice), B K-major in shared memory.
// Thread l of warp w holds rows 16w + l/4 (+ 8) of the fragment and
// columns 8j + 2(l % 4) (+ 1): d[4j + 2h + e] is (16w + l/4 + 8h,
// 8j + 2(l % 4) + e).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct Args {
  const float* bias;   // b_x [N]
  const int* lens;     // [B]
  int M, N, T, steps, ntiles, tiles, round_xg;
};

// The f32 words of k16 slice j (0..3) of a stage that a consumer thread
// rounds into its fragment: rows r0 (fragment row g) and r0 + 8, columns
// 2q, 2q + 1 and 2q + 8, 2q + 9 of the slice. off[j % 2][s] is the byte
// offset in a row of the x box j / 2 of chunk 4(j % 2) + 2s + q / 2 under
// the swizzle, plus 8 bytes for odd q.
struct Slice {
  float2 v[4];  // (r0, s=0), (r0+8, s=0), (r0, s=1), (r0+8, s=1)
};

__device__ __forceinline__ Slice read_slice(const uint8_t* stage, int j,
                                            int row0, const int (&off)[2][2]) {
  const uint8_t* box = stage + (j / 2) * kABoxBytes + row0 * 128;
  Slice s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v[i] = *reinterpret_cast<const float2*>(box + (i & 1) * 8 * 128
                                              + off[j & 1][i >> 1]);
  }
  return s;
}

// The fragment: register i holds (row g + 8 (i % 2), k pair 2q + 8 (i / 2)),
// the lower k at the lower half, rounded to nearest even.
__device__ __forceinline__ void round_slice(const Slice& s, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s.v[i].x, s.v[i].y);
}

// b_x at columns n, n + 1 of each 8-column group of a store box (n =
// the box's first column + 2q), 0 past N.
__device__ __forceinline__ void load_bias(float2 (&bias)[kOutCols / 8],
                                          const Args& args, int n) {
#pragma unroll
  for (int jj = 0; jj < kOutCols / 8; ++jj) {
    bias[jj] = n + 8 * jj < args.N
        ? __ldg(reinterpret_cast<const float2*>(args.bias + n + 8 * jj))
        : make_float2(0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
proj_kernel(const __grid_constant__ CUtensorMap x_map,
            const __grid_constant__ CUtensorMap w_map,
            const __grid_constant__ CUtensorMap out_map,
            const __grid_constant__ Args args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* outbuf = base + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + 4 * kOutBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);

  if (wg == 2) {  // the TMA warpgroup: one thread asks for every stage
    setmaxnreg_dec<kTmaRegs>();
    if (threadIdx.x != 256) return;
    int i = 0;
    for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {
      const int m0 = t / args.ntiles * kBM, n0 = t % args.ntiles * kBN;
      for (int k = 0; k < args.steps; ++k, ++i) {
        const int st = i % kStages;
        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        uint8_t* s = base + st * kStageBytes;
        mbar_expect_tx(full + st, kStageBytes);
#pragma unroll
        for (int b = 0; b < kABoxes; ++b) {
          tma_load_2d(s + b * kABoxBytes, &x_map, full + st, k * kBK + b * kBox, m0);
        }
        tma_load_2d(s + kABoxes * kABoxBytes, &w_map, full + st, k * kBK, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = lane == 0;
  const bool issuer = (threadIdx.x & 127) == 0;  // the stores' thread
  // this thread's fragment rows in the stage's tile: r0 and r0 + 8
  const int rg = row_of(g);
  const int row0 = 64 * wg + 16 * warp + rg;
  int off[2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      off[jj][s] = (((4 * jj + 2 * s + (q >> 1)) ^ rg) << 4) + 8 * (q & 1);
  const int half = args.N / 2;

  float acc[128];
  uint32_t fa[2][4];
  int i = 0;
  for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {
    const int m0 = t / args.ntiles * kBM, n0 = t % args.ntiles * kBN;
    // the epilogue's loads, issued now so that the products hide them:
    // whether each of this thread's two rows is past its length (b = m / T
    // once a row), and the bias of its columns of the first store box
    bool dead[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row0 + 8 * h;
      dead[h] = false;
      if (m < args.M) {
        const int b = m / args.T;
        dead[h] = m - b * args.T >= args.lens[b];
      }
    }
    float2 bias[kOutCols / 8];
    load_bias(bias, args, n0 + 2 * q);
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
    for (int k = 0; k < args.steps; ++k, ++i) {
      const int st = i % kStages;
      mbar_wait(full + st, (i / kStages) & 1);
      const uint8_t* s = base + st * kStageBytes;
      const uint64_t db = b_desc(s + kABoxes * kABoxBytes);
      // slice 0's fragment: its registers' last reader, the previous
      // stage's last product, is done
      round_slice(read_slice(s, 0, row0, off), fa[0]);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        fence_acc(acc);
        wgmma_fence();
        wgmma_m64n256k16_rs(acc, fa[j & 1], db + 2 * j);
        wgmma_commit();
        if (j + 1 < kBK / 16) {
          // the next slice read while this product runs, rounded once the
          // product before it (the fragment's last reader) is done
          const Slice next = read_slice(s, j + 1, row0, off);
          wgmma_wait<1>();
          fence_acc(acc);
          round_slice(next, fa[(j + 1) & 1]);
        }
      }
      // The stage is released as soon as its last product is done, not
      // after the next stage has arrived: while this warpgroup waits for
      // it, the TMA refills this stage (the other warpgroup's products
      // fill the tensor cores meanwhile).
      wgmma_wait<0>();
      fence_acc(acc);
      if (leader) mbar_arrive(empty + st);
    }

    // Epilogue: bias, the backward half masked past lens, round_xg; 32
    // columns at a time through a staging buffer and a TMA store, the next
    // box's bias loaded while this one is written.
#pragma unroll
    for (int c = 0; c < kBN / kOutCols; ++c) {
      uint8_t* buf = outbuf + (2 * wg + (c & 1)) * kOutBytes;
      float2 next[kOutCols / 8];
      if (c + 1 < kBN / kOutCols) load_bias(next, args, n0 + (c + 1) * kOutCols + 2 * q);
      // the store that read this buffer two boxes ago is done with it
      if (issuer) bulk_wait_read<1>();
      wg_sync(wg);
#pragma unroll
      for (int jj = 0; jj < kOutCols / 8; ++jj) {
        const int j = c * (kOutCols / 8) + jj;
        const int n = n0 + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] + bias[jj].x;
          float v1 = acc[4 * j + 2 * h + 1] + bias[jj].y;
          if (n >= half && dead[h]) v0 = v1 = 0.0f;
          if (args.round_xg) {
            v0 = __bfloat162float(__float2bfloat16_rn(v0));
            v1 = __bfloat162float(__float2bfloat16_rn(v1));
          }
          const int r = 16 * warp + rg + 8 * h;  // the buffer's row
          *reinterpret_cast<float2*>(buf + r * 128
              + (((2 * jj + (q >> 1)) ^ rg) << 4) + 8 * (q & 1)) =
              make_float2(v0, v1);
        }
      }
      fence_proxy_async();
      wg_sync(wg);
      if (issuer) {
        tma_store_2d(&out_map, buf, n0 + c * kOutCols, m0 + 64 * wg);
        bulk_commit();
      }
      if (c + 1 < kBN / kOutCols) {
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj) bias[jj] = next[jj];
      }
    }
    if (!PROJ_OVERLAP_EPILOGUE && issuer) bulk_wait<0>();
  }
  if (issuer) bulk_wait<0>();
}

// wt [N][ldw] = bf16(w [D][N])^T, 0 at d >= D: 32 x 32 tiles through
// shared memory, read along n and written along d.
constexpr int kWtTile = 32;

__global__ void __launch_bounds__(kWtTile * 8)
wt_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wt, int D,
          int N, int ldw) {
  __shared__ float tile[kWtTile][kWtTile + 1];
  const int n0 = blockIdx.x * kWtTile, d0 = blockIdx.y * kWtTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < kWtTile; i += 8) {
    const int d = d0 + i, n = n0 + tx;
    tile[i][tx] = d < D && n < N ? w[(size_t)d * N + n] : 0.0f;
  }
  __syncthreads();
  for (int i = ty; i < kWtTile; i += 8) {
    const int n = n0 + i, d = d0 + tx;
    if (n < N && d < ldw) wt[(size_t)n * ldw + d] = __float2bfloat16_rn(tile[tx][i]);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// A 2-D map of [d1][d0] (rows of ld elements), boxes {box0, box1} whose
// rows (box0 elements) are the swizzle's span, 64 or 128 bytes; out of
// bounds reads as 0 and is not written.
inline bool make_map(CUtensorMap* map, const void* p, bool bf16, int d0,
                     int d1, int ld, int box0, int box1) {
  const int span = box0 * (bf16 ? 2 : 4);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d0, (cuuint64_t)d1};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// xg [M, N] = bf16(x) . bf16(W_x) + b_x, the backward half masked, from x
// [M, D] with rows of ldx floats (a multiple of 4) and wx, W_x [D, N] f32,
// through wt16, the caller's scratch [N][ldw] (ldw a multiple of 8) that
// wt_kernel fills with bf16(W_x)^T; M = B*T, N = 8H. Every row written.
inline int launch_proj(const float* x, int ldx, const float* wx,
                       __nv_bfloat16* wt16, int ldw, const float* bias,
                       const int* lens, float* xg, int M, int N, int D, int T,
                       int round_xg, cudaStream_t st) {
  wt_kernel<<<dim3((N + kWtTile - 1) / kWtTile, (ldw + kWtTile - 1) / kWtTile),
              dim3(kWtTile, 8), 0, st>>>(wx, wt16, D, N, ldw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap x_map, w_map, out_map;
  if (!make_map(&x_map, x, false, D, M, ldx, kBox, kBM) ||
      !make_map(&w_map, wt16, true, D, N, ldw, kBK, kBN) ||
      !make_map(&out_map, xg, false, N, M, N, kOutCols, 64)) {
    return kNoTensorMap;
  }
  // every call: a function-local static of this inline function would be
  // one object across every library that holds it (a GNU unique symbol),
  // and a second build of this source in the process would launch unset
  e = cudaFuncSetAttribute(
      proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  Args args;
  args.bias = bias;
  args.lens = lens;
  args.M = M;
  args.N = N;
  args.T = T;
  args.steps = (D + kBK - 1) / kBK;
  args.ntiles = (N + kBN - 1) / kBN;
  args.tiles = (M + kBM - 1) / kBM * args.ntiles;
  args.round_xg = round_xg;
  const int sms = num_sms(), blocks = args.tiles < sms ? args.tiles : sms;
  proj_kernel<<<blocks, kThreads, kSmemBytes, st>>>(x_map, w_map, out_map, args);
  return (int)cudaGetLastError();
}

}  // namespace proj_sm90
