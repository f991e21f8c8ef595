// K2 and K3: the CTC alpha recursion and the fused beta recursion with the
// state posterior, for Hopper (sm_90a).
//
// Replace the TPU kernels gluon_e2e_asr_tpu/ops/pallas_ctc.py::alpha_pallas
// (pl.pallas_call at :134, body _alpha_kernel :55) and ::beta_post_pallas
// (pl.pallas_call at :164, body _beta_post_kernel :81). Same math on the
// blank-interleaved lattice of S = 2L+1 states, in log space with the
// sentinel NEG_INF = -1e30 (not -inf), and lse3(a, b, c) =
// m' + log(exp(a-m') + exp(b-m') + exp(c-m')) with m' = max(max(a,b,c), NEG_INF):
//
//   alpha, t = 0:  emit on states 0 and 1 (where valid), NEG_INF elsewhere
//   alpha, t > 0:  lse3(a[s], a[s-1], skip[s] ? a[s-2] : NEG_INF) + emit,
//                  NEG_INF on invalid states
//   beta:          emit + lse3(b[s], b[s+1], skipf2[s] ? b[s+2] : NEG_INF);
//                  at a row's last frame it restarts as emit on the two
//                  final states (finalok); NEG_INF on invalid states
//   both freeze a row past its length (the state carries over unchanged);
//   post = exp(clip(alpha + beta - emit - ll, 2*NEG_INF, 0)), 0 on
//          invalid states and past the row's length.
//
// Exact expf/logf (no fast-math intrinsics), the operands in the TPU
// kernels' order. Before t = 0 the alpha row holds the lax.scan path's
// initial state (0 at state 0, NEG_INF elsewhere); only a row whose first
// frame is masked ever shows it, and a row of length 0 carries no loss.
//
// What bounds them on this card: not bytes (the [T,B,S] f32 tables stream
// through once: 6 MB at T=100, B=96, S=161, 2 us at the memory rate) but
// the chain of T dependent steps. A lattice state's step is about 100
// instructions (lse3's three exact expf and its logf: 26 FFMA and 3 MUFU
// in the SASS), most of them one dependent chain. The first design
// (one block per utterance, one thread per state, the state row double
// buffered in shared memory) paid in every step, besides that chain, a
// device-memory load of the emission issued after the previous step's
// barrier, a shared-memory exchange of the whole row and a block barrier;
// and its wrappers launched up to 17 small device operations around it
// (the host-side masks).
//
// The design here (CTC_WARP 1), its plan chosen by measurement
// (tools/ctc_probe.py --plans; PERF.md):
//   - a row of S states, one block, on W = ceil(S/(32*CTC_KMAX)) warps,
//     lane l of warp w holding k = ceil(S/(32W)) contiguous states in
//     registers (at CTC_KMAX 2: 3 warps of 2 states a lane at S=161, 4 at
//     S=193); the neighbours across a lane boundary come from
//     __shfl_up_sync (K2: s-1, s-2) or __shfl_down_sync (K3: s+1, s+2),
//     and only each warp's two boundary states cross between warps,
//     through a shared-memory slot of the step's parity, with one barrier
//     a step among the row's warps. One row a block: at B=96 each row has
//     an SM, its warps on the SM's four schedulers.
//     One warp a row (CTC_KMAX 8, no barrier at all) puts k lse3s a step
//     on one scheduler, about 100k issue cycles: 1.4-2.6x slower than
//     the first design at the flagships' S. Handing the boundary pairs to
//     the neighbours through tagged slots without a barrier let the
//     polling warps take issue slots from the computing ones (about 3x
//     slower); four rows a block share one SM's schedulers (slower too).
//   - the emission row (and in K3 the alpha row) of steps t+1..t+CTC_DEPTH
//     is in flight while step t computes: 4-byte cp.async copies into a
//     shared-memory ring of CTC_DEPTH + 1 slots, a commit group a step.
//     A barrier waits for the loads issued before it, so a ring of plain
//     loads in registers brought nothing with a barrier a step; the
//     copies stay in flight across it. The rows start at 4-byte
//     boundaries only (odd S), hence 4-byte copies.
//   - a step's k lse3s are straight-line code and the masks are selps
//     (sel): a branch around a state's lse3 would serialise them.
//   - the row's time-mask column goes to shared memory once, in the
//     prologue; K3 counts it there for is_last. The masks are derived in
//     the kernel from allow_skip, state_valid, last_state and the time
//     mask (skipf2[s] = allow_skip[s+2], finalok = s in {last-1, last},
//     is_last[t] = t == count - 1: the TPU wrapper's definitions,
//     pallas_ctc.py:157-162), so the wrapper launches nothing else.
//   - the stores of alpha and post are not waited on.
// What is left on a step's chain: the shuffles, k lse3s, the boundary
// slot's store and load and the row's barrier.
//
// ctc_warp_plan picks (k, W, shared memory) by shape alone;
// ops/ctc.py::warp_plan mirrors it and passes its answer, and an entry
// that disagrees launches nothing (kPlanMismatch).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// 1: the warp design; 0: the build variant with the first design (one
// block per utterance, one thread per state) and its entries, kept for
// timing beside it (tools/ctc_probe.py).
#define CTC_WARP 1
// Lattice states a lane holds at most; a row of more than 32*CTC_KMAX
// states takes several warps.
#define CTC_KMAX 2
// Steps whose table rows are in flight ahead of the step that computes.
#define CTC_DEPTH 4
// Cuts of tools/ctc_probe.py --ablate (each build computes wrong results;
// only its time counts): 1 issues each step's loads inside its chain (the
// address depends on the previous step's state); 0 drops the per-step
// stores (one store a row at the end keeps the work alive).
#define CTC_CHAIN_LOADS 0
#define CTC_STORES 1

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxStates = 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90
constexpr int kPlanMismatch = -2;

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float ms = fmaxf(m, kNegInf);
  return ms + logf(expf(a0 - ms) + expf(a1 - ms) + expf(a2 - ms));
}

#if CTC_WARP

int cdiv(int a, int b) { return (a + b - 1) / b; }

// p ? a : b as one selp: both operands computed, no branch. A branch
// around a state's lse3 (a per-lane mask) would put each state in its own
// basic block, and the k states of a lane would run one after another.
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, q;\n\t}"
      : "=f"(r)
      : "r"((unsigned)p), "f"(a), "f"(b));
  return r;
}

static_assert(CTC_KMAX >= 1 && CTC_DEPTH >= 1,
              "a plan needs states and a step in flight");

// How a launch covers a [T,B,S] lattice: one block a batch row, k states
// a lane, W warps a row, and the block's dynamic shared memory: the
// boundary slots ([2 parities][W][2] floats), the prefetch ring (two
// tables' rows of CTC_DEPTH + 1 steps, 32Wk floats each) and the
// time-mask column (T bytes, padded to 16).
struct Plan {
  int k, W;
  size_t smem;
};

constexpr int kRing = CTC_DEPTH + 1;  // slots of the prefetch ring

__host__ __device__ inline size_t ring_at(int W) { return 16 * (size_t)W; }

__host__ __device__ inline size_t tmask_at(int W, int k) {
  return ring_at(W) + 2 * kRing * 128 * (size_t)W * k;
}

Plan ctc_warp_plan(int T, int S) {
  Plan p;
  p.W = cdiv(S, 32 * CTC_KMAX);
  p.k = cdiv(S, 32 * p.W);
  p.smem = tmask_at(p.W, p.k) + (((size_t)T + 15) & ~(size_t)15);
  return p;
}

// Warps a block at most under any plan of this build.
constexpr int kMaxWarps = (kMaxStates + 32 * CTC_KMAX - 1) / (32 * CTC_KMAX);
static_assert(kMaxWarps <= 32, "a row's warps fit a block");

struct Args {
  const float* emit;      // [T,B,S]
  const uint8_t* tmask;   // [T,B]
  const uint8_t* skip;    // allow_skip [B,S]
  const uint8_t* svalid;  // [B,S]
  const int* last;        // last_state [B] (K3)
  const float* alpha;     // [T,B,S] (K3 reads it)
  const float* ll;        // [B] (K3)
  float* out;             // alpha (K2) or post (K3), [T,B,S]
  int T, B, S, W;
};

// Where a lane stands: its row b (the block), warp w of the row's W, and
// its first state s0.
struct Lane {
  int b, w, lane, s0, n;  // n: the row's states from s0 on (S - s0)
  float* xch;             // [2][W][2]: each warp's boundary pair
  float* ring;            // [2 tables][kRing][32 W K]
  uint8_t* tm;            // [T]
};

__device__ __forceinline__ Lane lane_of(const Args& a, int K,
                                        unsigned char* smem) {
  Lane l;
  l.w = threadIdx.x >> 5;
  l.lane = threadIdx.x & 31;
  l.b = blockIdx.x;
  l.s0 = (l.w * 32 + l.lane) * K;
  l.n = a.S - l.s0;
  l.xch = reinterpret_cast<float*>(smem);
  l.ring = reinterpret_cast<float*>(smem + ring_at(a.W));
  l.tm = smem + tmask_at(a.W, K);
  return l;
}

// The row's warps (the block); one warp needs no barrier.
__device__ __forceinline__ void row_sync(int W) {
  if (W > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// The row's time-mask column into shared memory.
__device__ __forceinline__ void load_tmask(const Args& a, const Lane& l) {
  for (int t = l.w * 32 + l.lane; t < a.T; t += 32 * a.W)
    l.tm[t] = a.tmask[(size_t)t * a.B + l.b];
}

// This lane's k states of one [B,S] row of a table.
template <int K>
__device__ __forceinline__ void load_states(float (&dst)[K],
                                            const float* __restrict__ src,
                                            int n) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < n) dst[i] = __ldg(src + i);
}

// This lane's k states of one [B,S] row of a table into a ring slot, as
// 4-byte cp.async copies (a row starts at a 4-byte boundary only), zero
// past the row's end (read from ``safe``, a valid address, 0 bytes). A
// barrier does not wait for them, so the copies of the next steps stay
// in flight across the row's barrier, where plain loads would not.
template <int K>
__device__ __forceinline__ void fetch_states(float* dst,
                                             const float* __restrict__ src,
                                             int n, const float* safe) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(i < n ? src + i : safe), "r"(i < n ? 4 : 0)
                 : "memory");
  }
}

// A ring slot's k states of this lane, read after wait_fetches.
template <int K>
__device__ __forceinline__ void read_slot(float (&dst)[K], const float* slot,
                                          int n) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < n) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(slot + i);
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(dst[i]) : "r"(a));
    }
  }
}

__device__ __forceinline__ void commit_fetches() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void wait_fetches() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int K>
__device__ __forceinline__ void store_states(float* __restrict__ dst,
                                             const float (&v)[K], int n) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < n) dst[i] = v[i];
}

// K2. Grid B, 32W threads, plan.smem bytes.
template <int K>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    ctc_alpha_warp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane l = lane_of(a, K, smem);
  const int T = a.T, W = a.W;
  const unsigned full = 0xffffffffu;
  load_tmask(a, l);
  unsigned sk = 0, sv = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < l.n) {
      const size_t at = (size_t)l.b * a.S + l.s0 + i;
      sk |= (unsigned)(a.skip[at] != 0) << i;
      sv |= (unsigned)(a.svalid[at] != 0) << i;
    }
  }
  float st[K];
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = l.s0 + i == 0 ? 0.0f : kNegInf;
  const size_t step = (size_t)a.B * a.S;
  const float* er = a.emit + (size_t)l.b * a.S + l.s0;
  float* outp = a.out + (size_t)l.b * a.S + l.s0;
  // step t's emission row in ring slot t % kRing, a commit group a step
  const int nl = 32 * W * K;
  auto fetch = [&](int t) {
    if (t < T)
      fetch_states<K>(l.ring + (t % kRing) * nl + l.s0, er + (size_t)t * step,
                      l.n, a.emit);
    commit_fetches();
  };
#if !CTC_CHAIN_LOADS
  for (int j = 0; j < CTC_DEPTH; ++j) fetch(j);
#endif
  // A warp's last two states, for the next warp's lane 0 (and lane 1
  // where K = 1): s0+K-2 and s0+K-1 of lane 31 (K = 1: lanes 30 and 31),
  // pair q (the states after step q-1) in the slot of q's parity.
  const bool gives = l.w + 1 < W && l.lane >= (K >= 2 ? 31 : 30);
  auto give = [&](int q) {
    if (!gives) return;
    float* x = l.xch + ((q & 1) * W + l.w) * 2;
    if (K >= 2) {
      x[0] = st[K >= 2 ? K - 2 : 0];
      x[1] = st[K - 1];
    } else {
      x[l.lane - 30] = st[0];
    }
  };
  // lanes that take the warp below's pair
  const bool takes = l.lane < (K >= 2 ? 1 : 2);
  give(0);
  row_sync(W);
#if !CTC_STORES
  float sink = 0.0f;
#endif
  for (int t = 0; t < T; ++t) {
    float e[K];
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = 0.0f;
#if CTC_CHAIN_LOADS
    load_states<K>(e, er + t * step +
                          (__float_as_uint(st[0]) == 0x7fffffffu), l.n);
#else
    wait_fetches<CTC_DEPTH - 1>();  // step t's row has landed
    read_slot<K>(e, l.ring + (t % kRing) * nl + l.s0, l.n);
    fetch(t + CTC_DEPTH);  // into the slot step t-1 read
#endif
    const bool live = l.tm[t] != 0;
    // s0-1 and s0-2 from the lanes below; lane 0 (and lane 1 where
    // K = 1) from the warp below, or NEG_INF at the row's first states
    float m1 = __shfl_up_sync(full, st[K - 1], 1);
    float m2 = K >= 2 ? __shfl_up_sync(full, st[K >= 2 ? K - 2 : 0], 1)
                      : __shfl_up_sync(full, st[0], 2);
    if (takes) {
      float x0 = kNegInf, x1 = kNegInf;
      if (l.w > 0) {
        const float* x = l.xch + ((t & 1) * W + l.w - 1) * 2;
        x0 = x[0];
        x1 = x[1];
      }
      if (l.lane == 0) {
        m1 = x1;
        m2 = x0;
      } else {
        m2 = x1;  // K = 1, lane 1: s0-2 is the warp below's last
      }
    }
    // every state's lse3 first, straight-line, then the masks
    float l3[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float a1 = i >= 1 ? st[i >= 1 ? i - 1 : 0] : m1;
      const float a2 = i >= 2 ? st[i >= 2 ? i - 2 : 0] : (i == 1 ? m1 : m2);
      l3[i] = lse3(st[i], a1, sel((sk >> i) & 1u, a2, kNegInf));
    }
    float nw[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool valid = (sv >> i) & 1u;
      float v = sel(valid, l3[i] + e[i], kNegInf);
      // t = 0: emit on states 0 and 1
      v = sel(t == 0, sel(valid && l.s0 + i <= 1, e[i], kNegInf), v);
      nw[i] = sel(live, v, st[i]);  // freeze past the row's length
    }
#pragma unroll
    for (int i = 0; i < K; ++i) st[i] = nw[i];
    if (W > 1) {
      give(t + 1);
      row_sync(W);
    }
    // after the row's barrier; nothing waits for them
#if CTC_STORES
    store_states<K>(outp + (size_t)t * step, nw, l.n);
#else
#pragma unroll
    for (int i = 0; i < K; ++i) sink += nw[i];
#endif
  }
#if !CTC_STORES
  if (l.n > 0) outp[0] = sink;
#endif
}

// K3. Grid B, 32W threads, plan.smem bytes.
template <int K>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    ctc_beta_post_warp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane l = lane_of(a, K, smem);
  const int T = a.T, W = a.W, S = a.S;
  const unsigned full = 0xffffffffu;
  load_tmask(a, l);
  const int last = a.last[l.b];
  const float llb = a.ll[l.b];
  unsigned sk = 0, sv = 0, fok = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = l.s0 + i;
    if (s < S) {
      const size_t at = (size_t)l.b * S + s;
      // skipf2[s] = allow_skip[s+2], 0 past the row
      sk |= (unsigned)(s + 2 < S && a.skip[at + 2] != 0) << i;
      sv |= (unsigned)(a.svalid[at] != 0) << i;
      fok |= (unsigned)(s == last || s == last - 1) << i;
    }
  }
  float st[K];
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = kNegInf;
  const size_t step = (size_t)a.B * S;
  const size_t row0 = (size_t)l.b * S + l.s0;
  const float* er = a.emit + row0;
  const float* ar = a.alpha + row0;
  float* outp = a.out + row0;
  // the emission and alpha rows of step k (frame T-1-k) in ring slot
  // k % kRing of either table, a commit group a step
  const int nl = 32 * W * K;
  float* const aring = l.ring + kRing * nl;
  auto fetch = [&](int k) {
    if (k < T) {
      const size_t at = (size_t)(T - 1 - k) * step;
      fetch_states<K>(l.ring + (k % kRing) * nl + l.s0, er + at, l.n, a.emit);
      fetch_states<K>(aring + (k % kRing) * nl + l.s0, ar + at, l.n, a.emit);
    }
    commit_fetches();
  };
#if !CTC_CHAIN_LOADS
  for (int j = 0; j < CTC_DEPTH; ++j) fetch(j);
#endif
  // A warp's first two states, for the warp below's lane 31 (and lane 30
  // where K = 1): s0 and s0+1 of lane 0 (K = 1: lanes 0 and 1), pair q
  // in the slot of q's parity.
  const bool gives = l.w > 0 && l.lane < (K >= 2 ? 1 : 2);
  auto give = [&](int q) {
    if (!gives) return;
    float* x = l.xch + ((q & 1) * W + l.w) * 2;
    if (K >= 2) {
      x[0] = st[0];
      x[1] = st[K >= 2 ? 1 : 0];
    } else {
      x[l.lane] = st[0];
    }
  };
  // lanes that take the warp above's pair
  const bool takes = l.lane >= (K >= 2 ? 31 : 30);
  give(0);
  row_sync(W);
  // is_last: the TPU wrapper's t == sum(time_mask[:, b]) - 1, also for a
  // mask that is not a prefix
  int cnt = 0;
  for (int t = l.lane; t < T; t += 32) cnt += l.tm[t] != 0;
  const int t_last = __reduce_add_sync(full, cnt) - 1;
#if !CTC_STORES
  float sink = 0.0f;
#endif
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    float e[K], al[K];
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = al[i] = 0.0f;
#if CTC_CHAIN_LOADS
    const size_t dep = __float_as_uint(st[0]) == 0x7fffffffu;
    load_states<K>(e, er + t * step + dep, l.n);
    load_states<K>(al, ar + t * step + dep, l.n);
#else
    wait_fetches<CTC_DEPTH - 1>();
    read_slot<K>(e, l.ring + (k % kRing) * nl + l.s0, l.n);
    read_slot<K>(al, aring + (k % kRing) * nl + l.s0, l.n);
    fetch(k + CTC_DEPTH);
#endif
    const bool live = l.tm[t] != 0;
    // s0+K and s0+K+1 from the lanes above; lane 31 (and lane 30 where
    // K = 1) from the warp above, or NEG_INF past the row
    float p1 = __shfl_down_sync(full, st[0], 1);
    float p2 = K >= 2 ? __shfl_down_sync(full, st[K >= 2 ? 1 : 0], 1)
                      : __shfl_down_sync(full, st[0], 2);
    if (takes) {
      float x0 = kNegInf, x1 = kNegInf;
      if (l.w + 1 < W) {
        const float* x = l.xch + ((k & 1) * W + l.w + 1) * 2;
        x0 = x[0];
        x1 = x[1];
      }
      if (l.lane == 31) {
        p1 = x0;
        p2 = x1;
      } else {
        p2 = x0;  // K = 1, lane 30: s0+2 is the warp above's first
      }
    }
    // every state's lse3 first, straight-line, then the masks
    float l3[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float b1 = i + 1 < K ? st[i + 1 < K ? i + 1 : 0] : p1;
      const float b2 = i + 2 < K ? st[i + 2 < K ? i + 2 : 0]
                                 : (i + 2 == K ? p1 : p2);
      l3[i] = lse3(st[i], b1, sel((sk >> i) & 1u, b2, kNegInf));
    }
    float nw[K], po[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool valid = (sv >> i) & 1u;
      float v = e[i] + l3[i];
      // the row's last frame: emit on the two final states
      v = sel(t == t_last, sel((fok >> i) & 1u, e[i], kNegInf), v);
      v = sel(valid, v, kNegInf);
      v = sel(live, v, st[i]);  // freeze past the row's length
      nw[i] = v;
      const float gamma = al[i] + v - e[i];
      const float p = expf(fminf(fmaxf(gamma - llb, 2.0f * kNegInf), 0.0f));
      po[i] = sel(valid && live, p, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) st[i] = nw[i];
    if (W > 1) {
      give(k + 1);
      row_sync(W);
    }
#if CTC_STORES
    store_states<K>(outp + (size_t)t * step, po, l.n);
#else
#pragma unroll
    for (int i = 0; i < K; ++i) sink += po[i] + nw[i];
#endif
  }
#if !CTC_STORES
  if (l.n > 0) outp[0] = sink;
#endif
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, const Plan& p, cudaStream_t st) {
  if (p.smem > 48 * 1024) {
    // set on every call: a second copy of this library in one process
    // (a probe's build variant) must not skip it
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.B, 32 * p.W, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int launch_by_k(bool beta, const Args& a, const Plan& p, cudaStream_t st) {
  if constexpr (K > CTC_KMAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p.k != K) return launch_by_k<K + 1>(beta, a, p, st);
    return beta ? launch(ctc_beta_post_warp_kernel<K>, a, p, st)
                : launch(ctc_alpha_warp_kernel<K>, a, p, st);
  }
}

// Checks the caller's plan against this library's, then launches.
int run(bool beta, Args a, int k, int W, void* stream) {
  if (a.T <= 0 || a.B <= 0 || a.S <= 0 || a.S > kMaxStates)
    return (int)cudaErrorInvalidValue;
  const Plan p = ctc_warp_plan(a.T, a.S);
  if (p.k != k || p.W != W) return kPlanMismatch;
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  a.W = p.W;
  return launch_by_k<1>(beta, a, p, static_cast<cudaStream_t>(stream));
}

#else  // CTC_WARP 0: the first design

// Grid B, blockDim >= S. emit and alpha [T,B,S] f32; tmask [T,B];
// skip and svalid [B,S]; all masks uint8 (0 or 1).
__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const uint8_t* __restrict__ tmask,
                                 const uint8_t* __restrict__ skip,
                                 const uint8_t* __restrict__ svalid,
                                 float* __restrict__ alpha, int T, int B,
                                 int S) {
  extern __shared__ float as[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const bool sk = on && skip[b * S + s];
  const bool sv = on && svalid[b * S + s];
  const bool first_ok = s <= 1 && sv;
  if (on) as[s] = s == 0 ? 0.0f : kNegInf;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* a = as + cur * S;
    if (on) {
      const size_t at = ((size_t)t * B + b) * S + s;
      const float e = emit[at];
      const float prev = a[s];
      float nw;
      if (t == 0) {
        nw = first_ok ? e : kNegInf;
      } else {
        const float a1 = s >= 1 ? a[s - 1] : kNegInf;
        const float a2 = (sk && s >= 2) ? a[s - 2] : kNegInf;
        nw = sv ? lse3(prev, a1, a2) + e : kNegInf;
      }
      if (!tmask[t * B + b]) nw = prev;  // freeze past the row's length
      as[(cur ^ 1) * S + s] = nw;
      alpha[at] = nw;
    }
    __syncthreads();
    cur ^= 1;
  }
}

// Grid B, blockDim >= S. emit, alpha and post [T,B,S] f32; tmask and
// islast [T,B]; skipf2, svalid and finalok [B,S]; ll [B] f32.
__global__ void ctc_beta_post_kernel(const float* __restrict__ emit,
                                     const uint8_t* __restrict__ tmask,
                                     const uint8_t* __restrict__ islast,
                                     const uint8_t* __restrict__ skipf2,
                                     const uint8_t* __restrict__ svalid,
                                     const uint8_t* __restrict__ finalok,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ ll,
                                     float* __restrict__ post, int T, int B,
                                     int S) {
  extern __shared__ float bs[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < S;
  const bool sk = on && skipf2[b * S + s];
  const bool sv = on && svalid[b * S + s];
  const bool fok = on && finalok[b * S + s];
  const float llb = ll[b];
  if (on) bs[s] = kNegInf;
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    const float* bc = bs + cur * S;
    if (on) {
      const size_t at = ((size_t)t * B + b) * S + s;
      const float e = emit[at];
      const bool tm = tmask[t * B + b];
      const float prev = bc[s];
      const float b1 = s + 1 < S ? bc[s + 1] : kNegInf;
      const float b2 = (sk && s + 2 < S) ? bc[s + 2] : kNegInf;
      float nw = e + lse3(prev, b1, b2);
      if (islast[t * B + b]) nw = fok ? e : kNegInf;
      if (!sv) nw = kNegInf;
      if (!tm) nw = prev;
      bs[(cur ^ 1) * S + s] = nw;
      const float gamma = alpha[at] + nw - e;
      const float p = expf(fminf(fmaxf(gamma - llb, 2.0f * kNegInf), 0.0f));
      post[at] = (sv && tm) ? p : 0.0f;
    }
    __syncthreads();
    cur ^= 1;
  }
}

int threads_for(int S) { return ((S + 31) / 32) * 32; }

#endif  // CTC_WARP

}  // namespace

#if CTC_WARP

// Plain C interface (loaded with ctypes). Device pointers, layouts as in
// Args; masks uint8 (0 or 1; a bool tensor's bytes). (k, W) is the
// caller's copy of ctc_warp_plan for the shape; each entry returns
// kPlanMismatch (-2) without launching where it differs, else
// cudaGetLastError() after its launch (0 on success).
extern "C" int ctc_alpha(const float* emit, const uint8_t* tmask,
                         const uint8_t* skip, const uint8_t* svalid,
                         float* alpha, int T, int B, int S, int k, int W,
                         void* stream) {
  const Args a{emit, tmask, skip, svalid, nullptr, nullptr, nullptr, alpha,
               T,    B,     S,    0};
  return run(false, a, k, W, stream);
}

// last_state [B] int32 (2 * label_len); alpha [T,B,S] and ll [B] f32.
extern "C" int ctc_beta_post(const float* emit, const uint8_t* tmask,
                             const uint8_t* skip, const uint8_t* svalid,
                             const int* last_state, const float* alpha,
                             const float* ll, float* post, int T, int B,
                             int S, int k, int W, void* stream) {
  const Args a{emit, tmask, skip, svalid, last_state, alpha, ll, post,
               T,    B,     S,    0};
  return run(true, a, k, W, stream);
}

// ctc_warp_plan's answer for a shape: out = {k, W, shared bytes}.
extern "C" int ctc_plan(int T, int S, int* out) {
  const Plan p = ctc_warp_plan(T, S);
  out[0] = p.k;
  out[1] = p.W;
  out[2] = (int)p.smem;
  return 0;
}

#else

// The first design's entries: skipf2, finalok and islast from the caller.
extern "C" int ctc_alpha(const float* emit, const uint8_t* tmask,
                         const uint8_t* skip, const uint8_t* svalid,
                         float* alpha, int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0 || S > kMaxStates)
    return (int)cudaErrorInvalidValue;
  ctc_alpha_kernel<<<B, threads_for(S), 2 * S * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      emit, tmask, skip, svalid, alpha, T, B, S);
  return (int)cudaGetLastError();
}

extern "C" int ctc_beta_post(const float* emit, const uint8_t* tmask,
                             const uint8_t* islast, const uint8_t* skipf2,
                             const uint8_t* svalid, const uint8_t* finalok,
                             const float* alpha, const float* ll, float* post,
                             int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0 || S > kMaxStates)
    return (int)cudaErrorInvalidValue;
  ctc_beta_post_kernel<<<B, threads_for(S), 2 * S * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      emit, tmask, islast, skipf2, svalid, finalok, alpha, ll, post, T, B, S);
  return (int)cudaGetLastError();
}

#endif  // CTC_WARP

extern "C" const char* ctc_error_string(int code) {
  if (code == kPlanMismatch)
    return "the caller's (k, W) differ from ctc_warp_plan's";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
