// PTX helpers for Hopper (sm_90a) shared by the warp-specialised
// kernels: gemm_sm90.cuh's K1-bwd products and proj_sm90.cuh's K1-fwd
// projection. mbarriers, TMA copies, the 128-byte swizzle, wgmma's
// fences and descriptors, setmaxnreg, and libcuda's tensor-map
// encoder.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// One asm block, so that the compiler sees no divergent path around the
// products. No watchdog: a trap on the retry path behind a counter cost
// as much as a third more at the smallest shape measured (the "watchdog
// in the wait" variant of tools/k1b_probe.py --products --ablate;
// PERF.md).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// A 3-D box of the map at (c0, c1, c2) into shared memory, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kRegs));
}

// Descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); the leading offset is unused
// by this layout. The tile starts 1024-byte aligned, so the swizzle phase
// (base offset) is 0; one k16 step further is 32 bytes, 2 in the address
// field.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;          // leading byte offset (unused), 16 B
  d |= uint64_t(1024 >> 4) << 32;  // stride byte offset, 1024 B
  d |= uint64_t(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending) : "memory");
}

// Adds `bytes` to the transactions the current phase waits for, without
// arriving.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of the 16-byte chunk c (k = 8c .. 8c+7) of row r of a
// swizzled K-major tile: the TMA's and wgmma's 128-byte swizzle.
__device__ __forceinline__ int sw128_at(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

inline int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

}  // namespace sm90
