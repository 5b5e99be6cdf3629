// The exact cascade replay for Hopper (sm_90a): producer warps pre-test a
// row's positions ahead of its walk into a shared-memory ring, and one
// walker warp walks the ring, reading shared memory only.
//
// Replaces no Pallas kernel: in the reference the replay is a lax.scan over
// the visit positions inside a vmap over the rows, compiled by XLA
// (src/repro/core/engine.py:307 _replay_cascade).  For each row it walks
// the L positions p of order[row] with the running top-k (k distances, k
// row ids, ascending; bsf = its k-th distance):
//   lb-pruned       if d_lb[o] > bsf,
//   filter-pruned   else if d_F[o] > bsf,
//   else the leaf's kk values merge into the top-k: a stable sort of
//   [running top-k, leaf slots 0 .. kk-1] keeps the first k, so on a tie the
//   running entry comes first, then the lower slot.
// It writes topk_d (Q, k), topk_i (Q, k) and the three counters.  There is
// no arithmetic, only IEEE comparisons and selection, so it equals the
// plain loop (kernels/replay/ref.py) bitwise: a NaN compares false (a NaN
// bound or prediction prunes nothing; a NaN leaf value never enters, as
// torch.sort puts it last), -inf predictions never prune, and a +inf leaf
// value never displaces the running +inf entries ahead of it.
//
// Bound on an H100: every position needs its order entry (8 bytes) and its
// d_lb (4); a position its bound does not prune also its d_F (4), a
// searched one its kk values and an entering one its kk ids (ref.py's
// bound_bytes).  At the iSAX batch (256 x 7479, k = 5) that is 0.0093 ms at
// 3.35 TB/s, at calibration's largest call (11,520 x 7479, k = 1) 0.318
// ms.  The first design read every d_F.  The walk is
// a chain: a merge decides the bsf the next position is tested against, so
// a row's floor is its serial part, the leaves that enter the top-k merged
// one by one (6 a row at the batches, 1.5 at calibration) and its entries
// re-tested 32 at a time, once its loads are in.  The first design (one
// warp a row, 2 rows a block: 128 blocks of 2 warps at a batch; each
// step's gathers issued and used on the walk's critical path) ran at 0.7%
// and 7% of the bound.
//
// Design:
//   * A block is one row: a walker warp and PRODUCERS = 7 producer warps,
//     so a batch's 256 rows are 256 blocks and every SM holds one or two.
//     At calibration the same layout keeps few rows in flight on an SM (two
//     or three), whose bounds, predictions and leaf values stay in its L1
//     and in L2 while producers gather from them (bench/replay_layouts.py
//     times other layouts, given as sources: four rows a block of a walker
//     and a producer each, the shape sized for throughput, and one row with
//     3 or 15 producers were slower at the paths' calls).
//   * Producers take the row STEP positions at a time (64 while an entry
//     carries 8 slots, 128 beyond), step s by producer s % PRODUCERS: the
//     order entries are loaded a step ahead, d_lb gathered and pre-tested
//     against the newest bsf the walker has published in shared memory.
//     bsf never rises, so that stale bsf is at least the bsf just before the
//     position: a bound above it is lb-pruned for certain (counted and
//     dropped, its d_F never read).  For the rest d_F is gathered; a
//     prediction above the stale bsf can never be searched.  For a
//     candidate at the stale bsf (kk <= PRE) the producer loads the leaf's
//     kk values and keeps their least (NaN ignored), and for a leaf whose
//     least value lies below the bsf, the one kind that can change the
//     top-k, its ids.
//   * The producers write the kept positions in visit order (in turns,
//     step s after step s - 1, each lane's place known before its turn)
//     into the row's ring of RING entries: bound, prediction, least value
//     (+inf for a non-candidate), leaf index, and an entering leaf's slots.
//     Shared-memory flags with acquire and release order the ring: `posted`
//     (steps committed and entries written, one word) and `head` (entries
//     the walker is done with; a producer waits for room).
//   * The walker takes up to 32 entries at a time from shared memory and
//     re-tests them lane-parallel against its own bsf (bsf0): candidates
//     whose least value lies below bsf0 are walked one by one (each
//     re-tested against the current bsf, its slots merged from the ring;
//     a candidate with no value below bsf0 cannot change the top-k and is
//     not walked), then every entry is classified from the bsf just before
//     it (the bsf after the last walked entry before it), counted by
//     ballots.  It publishes its bsf after each step.  For k <= 32 and
//     kk <= PRE its loop issues no global load.
//   * A searched leaf's slots enter in slot order while they lie below the
//     bsf (each insertion goes after every entry <= it and drops the last:
//     the stable merge's order).  kk > PRE: the ring carries no slots, every
//     candidate is walked and its leaf read 32 slots at a time.  The top-k
//     lives in registers across the lanes for k <= 32 and in the row's
//     output buffer beyond: TopK in warp_topk.cuh.
//   * Counters: the producers' drops and the walker's lb-pruned entries are
//     n_plb, its filter-pruned entries n_pf, n_s = L - n_plb - n_pf.
//   * A wait past ~10 s of clock traps (a launch failure, not a hung card).
//   ref.py's replay_chunked emulates this walk for the CPU tests, with a
//   pre-test bsf that lags by a given number of chunks and a ring of a
//   given capacity.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "warp_topk.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_MAX_K = 32;            // top-k in registers up to this k
constexpr int RING = 256;                // ring entries a row
constexpr int PRE = 8;                   // leaf slots an entry carries
constexpr int PRODUCERS = 7;             // producer warps beside the walker
constexpr int THREADS = (1 + PRODUCERS) * 32;   // a block: one row
constexpr int MIN_BLOCKS = 2;            // blocks an SM: 128 registers

// a producer step: 32-position chunks (2 while an entry carries 8 slots,
// for the registers they take; 4 beyond) and positions
template <int NS>
constexpr int SUB = NS > 1 ? 2 : 4;
template <int NS>
constexpr int STEP = 32 * SUB<NS>;
static_assert((RING & (RING - 1)) == 0 && RING >= STEP<1>,
              "a power of two that takes a whole step");

// one row's ring; NS leaf slots an entry (NS = 0: kk > PRE, none)
template <int NS>
struct Ring {
  static constexpr int S = NS > 0 ? NS : 1;
  unsigned long long posted;             // steps committed << 32 | entries
  int head;                              // entries the walker is done with
  int dropped;                           // the producers' lb-pruned
  float bsf;                             // the walker's, published
  long long vi[S][RING];                 // an entering leaf's ids
  float v[S][RING];                      // and values
  float lb[RING], f[RING], vmin[RING];
  int o[RING];                           // the leaf (kk > PRE: the walk's)
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(hopper::smem_u32(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   hopper::smem_u32(p)),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];"
               : "=l"(v)
               : "r"(hopper::smem_u32(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;" ::"r"(
                   hopper::smem_u32(p)),
               "l"(v)
               : "memory");
}

// this thread's shared-memory writes ordered before its later ones (a
// lane's ring entries before the release its warp's lane 0 makes)
__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.cta.shared.f32 %0, [%1];"
               : "=f"(v)
               : "r"(hopper::smem_u32(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.cta.shared.f32 [%0], %1;" ::"r"(
                   hopper::smem_u32(p)),
               "f"(v)
               : "memory");
}

// a spin-wait past ~10 s of clock traps: a fault in the pipeline is then
// reported as a launch failure rather than a hung card
struct Patience {
  long long start = -1;
  __device__ __forceinline__ void check() {
    const long long now = clock64();
    if (start < 0)
      start = now;
    else if (now - start > (1ll << 34))
      __trap();
  }
};

// a searched leaf's kk slots into the top-k, in slot order (kk > PRE)
template <bool REG>
__device__ __forceinline__ void merge_leaf(TopK<REG>& top,
                                           const float* __restrict__ vals,
                                           const long long* __restrict__ ids,
                                           int kk, int lane) {
  for (int c0 = 0; c0 < kk; c0 += 32) {
    const int s = c0 + lane;
    const bool ok = s < kk;
    const float v = ok ? __ldg(vals + s) : 0.f;
    const long long vi = ok ? __ldg(ids + s) : 0;
    unsigned enter = __ballot_sync(FULL, ok && v < top.bsf);
    while (enter) {
      const int e = __ffs(enter) - 1;
      enter &= enter - 1;
      const float ve = __shfl_sync(FULL, v, e);
      const long long ie = __shfl_sync(FULL, vi, e);
      if (ve < top.bsf) top.insert(ve, ie);   // the bsf may have fallen
    }
  }
}

// an entering leaf's kk <= NS slots, from ring entry e, into the top-k
template <bool REG, int NS>
__device__ __forceinline__ void merge_ring(TopK<REG>& top,
                                           const Ring<NS>& ring, int e,
                                           int kk) {
  float v[NS];
  long long vi[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    v[t] = t < kk ? ring.v[t][e] : INFINITY;
    vi[t] = t < kk ? ring.vi[t][e] : 0;
  }
#pragma unroll
  for (int t = 0; t < NS; ++t)
    if (v[t] < top.bsf) top.insert(v[t], vi[t]);
}

// the walker: every ring entry in order; returns (lb-pruned, filter-pruned)
// among them
template <bool REG, int NS>
__device__ __forceinline__ int2 walk(Ring<NS>& ring, TopK<REG>& top,
                                     const float* __restrict__ ldr,
                                     const long long* __restrict__ lir,
                                     int kk, int n_steps, int lane) {
  int head = 0, plb = 0, pf = 0;
  Patience idle;
  while (true) {
    const unsigned long long posted = ld_acquire(&ring.posted);
    const int tail = static_cast<int>(posted & 0xffffffffu);
    if (tail == head) {
      if (static_cast<int>(posted >> 32) == n_steps) break;
      idle.check();
      continue;
    }
    idle.start = -1;
    const int n = min(tail - head, 32);
    const bool valid = lane < n;
    const int e = (head + lane) & (RING - 1);
    float lb = 0.f, f = 0.f, vmin = INFINITY;
    if (valid) {
      lb = ring.lb[e];
      f = ring.f[e];
      vmin = ring.vmin[e];
    }
    const float bsf0 = top.bsf;
    const bool cand = valid && !(lb > bsf0) && !(f > bsf0);
    unsigned go = __ballot_sync(FULL, cand && vmin < bsf0);
    float seen = bsf0;                   // the bsf just before this entry
    while (go) {
      const int j = __ffs(go) - 1;
      go &= go - 1;
      const float lbj = __shfl_sync(FULL, lb, j);
      const float fj = __shfl_sync(FULL, f, j);
      if (!(lbj > top.bsf) && !(fj > top.bsf)) {
        const int ej = (head + j) & (RING - 1);
        if constexpr (NS > 0) {
          merge_ring<REG, NS>(top, ring, ej, kk);
        } else {
          const long long oj = ring.o[ej];
          merge_leaf<REG>(top, ldr + oj * kk, lir + oj * kk, kk, lane);
        }
      }
      if (lane > j) seen = top.bsf;
    }
    plb += __popc(__ballot_sync(FULL, valid && lb > seen));
    pf += __popc(__ballot_sync(FULL, valid && !(lb > seen) && f > seen));
    head += n;
    __syncwarp();
    if (lane == 0) {
      st_relaxed(&ring.bsf, top.bsf);
      st_release(&ring.head, head);
    }
  }
  return make_int2(plb, pf);
}

// producer `first` of `producers`: steps first, first + producers, ...
template <int NS>
__device__ __forceinline__ void produce(
    Ring<NS>& ring, const long long* __restrict__ ord,
    const float* __restrict__ lbr, const float* __restrict__ fr,
    const float* __restrict__ ldr, const long long* __restrict__ lir, int L,
    int kk, int first, int n_steps, int lane) {
  constexpr int C = SUB<NS>, S = NS > 0 ? NS : 1;
  long long next[C];
  auto fetch = [&](int s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int p = s * STEP<NS> + c * 32 + lane;
      next[c] = p < L ? __ldg(ord + p) : 0;
    }
  };
  if (first < n_steps) fetch(first);
  int dropped = 0;
  for (int s = first; s < n_steps; s += PRODUCERS) {
    long long o[C];
    bool ok[C];
    float lb[C], f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[c] = next[c];
      ok[c] = s * STEP<NS> + c * 32 + lane < L;
    }
    if (s + PRODUCERS < n_steps) fetch(s + PRODUCERS);
#pragma unroll
    for (int c = 0; c < C; ++c) lb[c] = ok[c] ? __ldg(lbr + o[c]) : 0.f;
    // the pre-test, against the walker's newest bsf: a bound above it is
    // lb-pruned for certain, and its prediction is never read
    const float bsf_a = ld_relaxed(&ring.bsf);
    bool need[C], cand[C], enter[C];
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      need[c] = ok[c] && !(lb[c] > bsf_a);
      any |= need[c];
      f[c] = 0.f;
    }
    if (__any_sync(FULL, any)) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (need[c]) f[c] = __ldg(fr + o[c]);
    }
    float vmin[C];
    float v[C][S];
    long long vi[C][S];
    any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cand[c] = need[c] && !(f[c] > bsf_a);
      any |= cand[c];
      vmin[c] = NS > 0 ? INFINITY : (cand[c] ? -INFINITY : INFINITY);
      enter[c] = false;
    }
    if constexpr (NS > 0) {
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int t = 0; t < NS; ++t)
            v[c][t] = cand[c] && t < kk ? __ldg(ldr + o[c] * kk + t)
                                        : INFINITY;
        const float bsf_b = ld_relaxed(&ring.bsf);
        any = false;
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int t = 0; t < NS; ++t) vmin[c] = fminf(vmin[c], v[c][t]);
          enter[c] = cand[c] && vmin[c] < bsf_b;
          any |= enter[c];
        }
        if (__any_sync(FULL, any)) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int t = 0; t < NS; ++t)
              vi[c][t] = enter[c] && t < kk ? __ldg(lir + o[c] * kk + t) : 0;
        }
      }
    }
    // kept: not lb-pruned for certain at the newest bsf; each kept lane's
    // place among the step's entries is known before its turn
    const float bsf_c = ld_relaxed(&ring.bsf);
    unsigned kept[C];
    int n = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kept[c] = __ballot_sync(FULL, ok[c] && !(lb[c] > bsf_c));
      dropped += __popc(__ballot_sync(FULL, ok[c])) - __popc(kept[c]);
      n += __popc(kept[c]);
    }
    // in turn: every earlier step's entries are in the ring
    Patience turn;
    unsigned long long posted;
    while (((posted = ld_acquire(&ring.posted)) >> 32) !=
           static_cast<unsigned>(s))
      turn.check();
    const int tail = static_cast<int>(posted & 0xffffffffu);
    if (n > 0) {
      Patience room;
      while (tail + n - ld_acquire(&ring.head) > RING) room.check();
      int base = tail;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (kept[c] >> lane & 1u) {
          const int e =
              (base + __popc(kept[c] & ((1u << lane) - 1u))) & (RING - 1);
          ring.lb[e] = lb[c];
          ring.f[e] = f[c];
          ring.vmin[e] = vmin[c];
          ring.o[e] = static_cast<int>(o[c]);
          if constexpr (NS > 0) {
            if (enter[c]) {
#pragma unroll
              for (int t = 0; t < NS; ++t) {
                ring.v[t][e] = v[c][t];
                ring.vi[t][e] = vi[c][t];
              }
            }
          }
        }
        base += __popc(kept[c]);
      }
      fence_cta();
    }
    __syncwarp();
    if (lane == 0)
      st_release(&ring.posted,
                 (static_cast<unsigned long long>(s + 1) << 32) |
                     static_cast<unsigned>(tail + n));
  }
  if (lane == 0 && dropped) atomicAdd(&ring.dropped, dropped);
}

template <bool REG, int NS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
replay_kernel(const float* __restrict__ leaf_d,
              const long long* __restrict__ leaf_i, long long row_stride,
              const float* __restrict__ d_lb, const float* __restrict__ d_F,
              const long long* __restrict__ order, float* topk_d,
              long long* topk_i, int* __restrict__ n_s,
              int* __restrict__ n_plb, int* __restrict__ n_pf, int Q, int L,
              int kk, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring<NS>& ring = *reinterpret_cast<Ring<NS>*>(smem);
  if (warp == 0 && lane == 0) {                     // warp 0: the walker
    ring.posted = 0;
    ring.head = ring.dropped = 0;
    ring.bsf = INFINITY;
  }
  __syncthreads();
  const int r = blockIdx.x;
  const int n_steps = (L + STEP<NS> - 1) / STEP<NS>;
  const long long* ord = order + (long long)r * L;
  const float* ldr = leaf_d + r * row_stride;
  const long long* lir = leaf_i + r * row_stride;
  int2 pruned = make_int2(0, 0);
  if (warp > 0) {
    produce<NS>(ring, ord, d_lb + (long long)r * L, d_F + (long long)r * L,
                ldr, lir, L, kk, warp - 1, n_steps, lane);
  } else {
    float* td = topk_d + (long long)r * k;
    long long* ti = topk_i + (long long)r * k;
    TopK<REG> top(td, ti, k, lane);
    pruned = walk<REG, NS>(ring, top, ldr, lir, kk, n_steps, lane);
    top.store(td, ti);
  }
  __syncthreads();                                  // the drops are in
  if (warp == 0 && lane == 0) {
    const int plb = pruned.x + ring.dropped;
    n_plb[r] = plb;
    n_pf[r] = pruned.y;
    n_s[r] = L - plb - pruned.y;
  }
}

struct Args {
  const float* ld;
  const long long* li;
  long long row_stride;
  const float* lb;
  const float* f;
  const long long* o;
  float* td;
  long long* ti;
  int *s, *plb, *pf;
  int Q, L, kk, k;
};

template <bool REG, int NS>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(Ring<NS>);
  auto* kern = replay_kernel<REG, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<a.Q, THREADS, smem, st>>>(a.ld, a.li, a.row_stride, a.lb, a.f,
                                      a.o, a.td, a.ti, a.s, a.plb, a.pf, a.Q,
                                      a.L, a.kk, a.k);
  return cudaGetLastError();
}

template <bool REG>
cudaError_t launch_kk(const Args& a, cudaStream_t st) {
  if (a.kk <= 1) return launch<REG, 1>(a, st);
  if (a.kk <= PRE) return launch<REG, PRE>(a, st);
  return launch<REG, 0>(a, st);
}

}  // namespace

// leaf_d (Q, L, kk) float32 and leaf_i (Q, L, kk) int64, rows row_stride
// elements apart, each row's (L, kk) block contiguous; d_lb, d_F (Q, L)
// float32 and order (Q, L) int64, contiguous, order's entries in [0, L)
// -> topk_d (Q, k) float32, topk_i (Q, k) int64, n_s, n_plb, n_pf (Q,)
// int32.
extern "C" int replay(const void* leaf_d, const void* leaf_i,
                      long long row_stride, const void* d_lb,
                      const void* d_F, const void* order, void* topk_d,
                      void* topk_i, void* n_s, void* n_plb, void* n_pf,
                      int Q, int L, int kk, int k, void* stream) {
  if (Q <= 0) return cudaGetLastError();
  if (k <= 0 || L < 0 || kk < 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(leaf_d),
               static_cast<const long long*>(leaf_i),
               row_stride,
               static_cast<const float*>(d_lb),
               static_cast<const float*>(d_F),
               static_cast<const long long*>(order),
               static_cast<float*>(topk_d),
               static_cast<long long*>(topk_i),
               static_cast<int*>(n_s),
               static_cast<int*>(n_plb),
               static_cast<int*>(n_pf),
               Q,
               L,
               kk,
               k};
  const auto st = static_cast<cudaStream_t>(stream);
  return k <= REG_MAX_K ? launch_kk<true>(a, st) : launch_kk<false>(a, st);
}
