// The single-query early-termination walk for Hopper (sm_90a): scorer warps
// on every SM score a query's leaves ahead of the walk into a ring in
// global memory, and one walker warp walks the ring in visit order.
//
// Replaces no Pallas kernel: in the reference the walk is a jitted
// lax.while_loop over the visit order (src/repro/core/search.py:327
// _search_early_core).  With the running top-k (k distances and sorted-row
// ids, ascending; bsf = its k-th distance) it visits the leaves in `order`:
//   stop            at the first position whose bound is not <= bsf,
//   filter-pruned   if d_F[leaf] > bsf,
//   else searched:  each row's distance sqrt(sum (s - q)^2) merges into the
//                   top-k (a stable top-k of [running top-k, the leaf's
//                   rows]: ties go to the running top-k, then the lower
//                   row).
// It writes topk_d (k), topk_i (k) and the counters n_searched, n_visited
// (pruned by the bound = L - n_visited) and n_pruned_filter.  Each row's
// sum is taken in one fixed order, with no fused multiply-add: element j
// goes to lane (j / 4) % 32, each lane adds its squares in increasing j,
// the 32 lane sums are added by halving (16, 8, 4, 2, 1), and the root is
// rounded once (__fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn).
// kernels/early_walk/ref.py reproduces that order with float32 torch ops,
// so the plain walk (ref.early_walk) equals this kernel bitwise: the top-k
// values, the ids and the three counters.
//
// Bound on an H100: the walk must read each visited position's order entry,
// bound and prediction, and every searched leaf's rows (ref.bound_bytes):
// at k = 5, exact, on the 1M x 256 DSTree index about 812 leaves of ~244
// rows of 1 KiB, ~0.2 GB, 0.06 ms at 3.35 TB/s.  Bytes bound it, but only
// if many leaves are read at once: one warp reading one leaf at a time
// reads at one SM's share of the rate.  The decisions are a chain (a merge
// sets the bsf the next position is tested against), but few leaves
// enter the top-k.
//
// Design:
//   * A persistent grid of one block of WARPS warps on every SM, launched
//     cooperatively (cudaLaunchAttributeCooperative), so every block is
//     resident: a walker that waits on a scorer never waits on one that has
//     not started.  Warp 0 of block 0 is the walker, every other warp a
//     scorer.
//   * A leaf is `cpl` items of `ch` rows (a power of two of items, at most
//     32: ref.items_per_leaf), so a 245-row leaf is four items and its rows
//     are read by four warps at once.  Scorers claim items in visit order
//     (one atomic counter) while the ring has room: RING item slots, RING /
//     cpl leaf slots, and an item of the leaf at position p waits until the
//     walker is done with position p - RING / cpl.  Each pre-tests its
//     item against the bsf the walker last published: the bsf never rises,
//     so a bound above it ends the walk for certain (the scorer marks the
//     position, and no scorer claims a later one) and a prediction above it
//     is never searched.  For any other item the scorer reads its rows,
//     GROUP rows in flight a warp (16-byte loads where m % 4 == 0), and
//     keeps the k smallest distances below that bsf (ties to the lower
//     row), re-reading the published bsf every GROUP rows and dropping the
//     item where the bsf then decides it.  It writes the item's k values
//     and ids into its item slot, the leaf's bound and prediction and (an
//     atomic max of an order-reversing code) the least value of its items
//     into the leaf slot, fences, and adds one to the leaf slot's count
//     with release order.  A slot's count only grows (cpl a lap), so the
//     zeroed counts and a slot's older leaves never read as complete.
//   * The walker takes up to 32 complete leaves at a time, one a lane, so
//     a step's length does not depend on cpl; it re-tests them
//     lane-parallel against its own bsf and merges one by one, item by
//     item, only searched leaves whose least value lies below it; each
//     leaf is decided from the bsf just before it (the bsf after the last
//     merge before it).  It clears the least values it has read, and
//     publishes its bsf and its progress after each step, and `done` when
//     it stops.
//   * The top-k lives in registers across the lanes for k <= 32 and in the
//     output row (the walker) or the slot (a scorer) beyond: TopK in
//     warp_topk.cuh.
//   * A wait past ~10 s of clock traps (a launch failure, not a hung card).
// ref.py's walk_emulated emulates this protocol for the CPU tests, with a
// published bsf that lags by a given number of steps and a ring of a given
// size.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "warp_topk.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_MAX_K = 32;            // top-k in registers up to this k
constexpr int RING = 2048;               // ring slots (items)
constexpr int WARPS = 8;                 // a block: 8 warps, one per SM
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 8;                 // rows a scorer warp has in flight
constexpr int CTL = 8;                   // control words before the counts
constexpr unsigned INF_BITS = 0x7f800000u;
static_assert((RING & (RING - 1)) == 0 && RING >= 32, "a power of two");

// ctl: int32 words, zeroed before each launch
//   [0] next   items claimed by the scorers
//   [1] cut    L - (the first position found to end the walk), 0: none
//   [2] head   positions the walker is done with
//   [4..5]     the walker's state, 64 bits: done << 32 | (bsf bits ^
//              INF_BITS), so the zeroed word reads bsf = +inf
//   [CTL ..]        the leaf slots' counts of items written (RING / cpl used)
//   [CTL + RING ..] the leaf slots' least values, coded INF_BITS - bits, so
//                   a larger code is a smaller value and 0 reads +inf
struct Args {
  const float* series;
  const long long* leaf_start;
  const long long* leaf_size;
  const float* q;
  const float* d_lb;
  const float* d_F;
  const long long* order;
  float* topk_d;
  long long* topk_i;
  int* counts;            // n_searched, n_visited, n_pruned_filter
  int* ctl;
  float* ring_f;          // lb[RING], f[RING] (leaf slots), vals[RING][k]
  long long* ring_i;      // ids[RING][k]
  int L, m, k, ch, cpl;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ float bsf_of(unsigned long long state) {
  return __uint_as_float(static_cast<unsigned>(state) ^ INF_BITS);
}

__device__ __forceinline__ unsigned long long state_of(float bsf, bool done) {
  return (static_cast<unsigned long long>(done) << 32) |
         (__float_as_uint(bsf) ^ INF_BITS);
}

// a spin-wait past ~10 s of clock traps: a fault in the protocol is then
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

// acc + (s - q)^2, each step rounded on its own
__device__ __forceinline__ float term(float acc, float s, float q) {
  const float t = __fsub_rn(s, q);
  return __fadd_rn(acc, __fmul_rn(t, t));
}

// the distances of rows[0 .. n) (n <= GROUP, rows m floats apart) to the
// query qs (shared memory), in the fixed order, in every lane
template <bool VEC>
__device__ __forceinline__ void row_group(const float* __restrict__ rows,
                                          int n, int m, const float* qs,
                                          int lane, float (&d)[GROUP]) {
  float acc[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;
  for (int j0 = 0; j0 < m; j0 += 128) {
    const int j = j0 + 4 * lane;
    if constexpr (VEC) {
      const bool in = j < m;              // m % 4 == 0: the whole vector
      float4 s[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        s[g] = in && g < n ? __ldg(reinterpret_cast<const float4*>(
                                 rows + static_cast<long long>(g) * m + j))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + j);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          acc[g] = term(acc[g], s[g].x, qv.x);
          acc[g] = term(acc[g], s[g].y, qv.y);
          acc[g] = term(acc[g], s[g].z, qv.z);
          acc[g] = term(acc[g], s[g].w, qv.w);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j + e < m;
        float s[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
          s[g] = in && g < n
                     ? __ldg(rows + static_cast<long long>(g) * m + j + e)
                     : 0.f;
        if (in) {
          const float qv = qs[j + e];
#pragma unroll
          for (int g = 0; g < GROUP; ++g) acc[g] = term(acc[g], s[g], qv);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[g] = __fadd_rn(acc[g], __shfl_xor_sync(FULL, acc[g], off));
    d[g] = __fsqrt_rn(acc[g]);
  }
}

__device__ __forceinline__ float least(const TopK<true>& top) {
  return __shfl_sync(FULL, top.d, 0);
}

__device__ __forceinline__ float least(const TopK<false>& top) {
  __syncwarp();
  return top.d[0];
}

// a scorer warp: items in visit order until none is left or the walk ends
template <bool REG, bool VEC>
__device__ void score(const Args& a, const float* qs, int lane) {
  int* next = a.ctl;
  int* cut = a.ctl + 1;
  const int* head = a.ctl + 2;
  const auto* state = reinterpret_cast<const unsigned long long*>(a.ctl + 4);
  int* count = a.ctl + CTL;
  int* least_code = a.ctl + CTL + RING;
  float* ring_lb = a.ring_f;
  float* ring_fp = a.ring_f + RING;
  float* ring_v = a.ring_f + 2 * RING;
  const int items = a.L * a.cpl;
  const int slots = RING / a.cpl;                // leaf slots
  while (true) {
    int t = 0;
    if (lane == 0) t = atomicAdd(next, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= items) return;
    const int p = t / a.cpl, c = t % a.cpl;
    if (p > a.L - ld_relaxed(cut)) return;      // past a certain end
    Patience room;
    while (p - ld_acquire(head) >= slots) {      // the walker frees p's slot
      if (ld_relaxed(state) >> 32) return;
      room.check();
      __nanosleep(128);
    }
    const int e = t & (RING - 1);
    const long long o = __ldg(a.order + p);
    const float lb = __ldg(a.d_lb + o), f = __ldg(a.d_F + o);
    unsigned long long st = ld_relaxed(state);
    if (st >> 32) return;
    float cap = bsf_of(st);
    bool stop = !(lb <= cap);
    bool keep = !stop && !(f > cap);
    float vmin = INFINITY;
    float* sv = ring_v + static_cast<long long>(e) * a.k;
    long long* si = a.ring_i + static_cast<long long>(e) * a.k;
    if (keep) {
      const long long start = __ldg(a.leaf_start + o);
      const int size = static_cast<int>(__ldg(a.leaf_size + o));
      const int r_begin = min(c * a.ch, size);
      const int r_end = c == a.cpl - 1 ? size : min(size, r_begin + a.ch);
      TopK<REG> top(sv, si, a.k, lane);
      for (int r0 = r_begin; r0 < r_end; r0 += GROUP) {
        st = ld_relaxed(state);                  // beside the rows' loads
        float d[GROUP];
        const int n = min(GROUP, r_end - r0);
        row_group<VEC>(a.series + (start + r0) * a.m, n, a.m, qs, lane, d);
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
          if (g < n && d[g] < top.bsf && d[g] < cap)
            top.insert(d[g], start + r0 + g);
        if (st >> 32) return;                    // the walk has ended
        cap = bsf_of(st);
        if (!(lb <= cap) || f > cap) {           // decided without the rows
          stop = !(lb <= cap);
          keep = false;
          break;
        }
      }
      if (keep) {
        vmin = least(top);
        top.store(sv, si);
      }
    }
    const int ps = p % slots;
    if (lane == 0) {
      if (stop) atomicMax(cut, a.L - p);
      if (c == 0) {
        ring_lb[ps] = lb;
        ring_fp[ps] = f;
      }
      if (vmin < INFINITY)
        atomicMax(least_code + ps,
                  static_cast<int>(INF_BITS - __float_as_uint(vmin)));
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) red_add_release(count + ps, 1);
  }
}

// item slot e's values (ascending, +inf past its count) into the top-k
// while they lie below the bsf
template <bool REG>
__device__ __forceinline__ void merge_slot(TopK<REG>& top, const Args& a,
                                           int e, int lane) {
  const float* sv = a.ring_f + 2 * RING + static_cast<long long>(e) * a.k;
  const long long* si = a.ring_i + static_cast<long long>(e) * a.k;
  for (int c0 = 0; c0 < a.k; c0 += 32) {
    const int s = c0 + lane;
    const bool ok = s < a.k;
    const float v = ok ? __ldcg(sv + s) : INFINITY;
    const long long vi = ok ? __ldcg(si + s) : 0;
    unsigned enter = __ballot_sync(FULL, v < top.bsf);
    if (!enter) break;                           // ascending: none later
    while (enter) {
      const int j = __ffs(enter) - 1;
      enter &= enter - 1;
      const float vj = __shfl_sync(FULL, v, j);
      const long long ij = __shfl_sync(FULL, vi, j);
      if (vj < top.bsf) top.insert(vj, ij);      // the bsf may have fallen
    }
  }
}

// the walker: leaves in visit order, 32 at a time, until the walk ends
template <bool REG>
__device__ void walk(const Args& a, int lane) {
  int* head_pub = a.ctl + 2;
  auto* state = reinterpret_cast<unsigned long long*>(a.ctl + 4);
  const int* count = a.ctl + CTL;
  int* least_code = a.ctl + CTL + RING;
  const float* ring_lb = a.ring_f;
  const float* ring_fp = a.ring_f + RING;
  TopK<REG> top(a.topk_d, a.topk_i, a.k, lane);
  const int per = a.cpl, slots = RING / per;
  int head = 0, n_s = 0, n_pf = 0;
  bool stopped = false;
  Patience idle;
  while (!stopped && head < a.L) {
    const int n = min(32, a.L - head);
    const int p = head + lane, ps = p % slots;
    // every item of the leaf written: the slot's count ends its lap
    const bool ready =
        lane < n && ld_acquire(count + ps) == (p / slots + 1) * per;
    const unsigned rm = __ballot_sync(FULL, ready);
    const int nr = rm == FULL ? 32 : __ffs(~rm) - 1;
    if (nr == 0) {
      idle.check();
      continue;
    }
    idle.start = -1;
    float lb = 0.f, f = 0.f, vmin = INFINITY;
    if (lane < nr) {
      lb = __ldcg(ring_lb + ps);
      f = __ldcg(ring_fp + ps);
      vmin = __uint_as_float(INF_BITS -
                             static_cast<unsigned>(__ldcg(least_code + ps)));
    }
    const float bsf0 = top.bsf;
    unsigned go = __ballot_sync(
        FULL, lane < nr && lb <= bsf0 && !(f > bsf0) && vmin < bsf0);
    float seen = bsf0;                    // the bsf just before this leaf
    int last = -1, stop_at = nr;
    while (true) {
      const int j = go ? __ffs(go) - 1 : nr;
      const int hi = min(j, nr - 1);
      const unsigned ends =
          __ballot_sync(FULL, lane > last && lane <= hi && !(lb <= seen));
      if (ends) {
        stop_at = __ffs(ends) - 1;
        stopped = true;
        break;
      }
      if (j >= nr) break;
      go &= go - 1;
      if (!(__shfl_sync(FULL, f, j) > top.bsf)) {
        const int sj = (head + j) % slots;
        ld_acquire(count + sj);           // leaf j's items, seen by every lane
        for (int c = 0; c < per; ++c)
          merge_slot<REG>(top, a, sj * per + c, lane);
      }
      if (lane > j) seen = top.bsf;
      last = j;
    }
    const bool counted = lane < stop_at;
    n_pf += __popc(__ballot_sync(FULL, counted && f > seen));
    n_s += __popc(__ballot_sync(FULL, counted && !(f > seen)));
    if (counted) least_code[ps] = 0;      // the slot's next leaf starts at +inf
    head += stop_at;
    __syncwarp();
    if (lane == 0) {
      st_relaxed(state, state_of(top.bsf, stopped || head >= a.L));
      st_release(head_pub, head);
    }
  }
  if (lane == 0 && a.L == 0) st_relaxed(state, state_of(top.bsf, true));
  top.store(a.topk_d, a.topk_i);
  if (lane == 0) {
    a.counts[0] = n_s;
    a.counts[1] = head;
    a.counts[2] = n_pf;
  }
}

template <bool REG, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) early_walk_kernel(Args a) {
  extern __shared__ __align__(16) float qs[];
  for (int i = threadIdx.x; i < a.m; i += THREADS) qs[i] = a.q[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (blockIdx.x == 0 && warp == 0)
    walk<REG>(a, lane);
  else
    score<REG, VEC>(a, qs, lane);
}

using Kernel = void (*)(Args);

Kernel pick(int k, int vec) {
  if (k <= REG_MAX_K)
    return vec ? early_walk_kernel<true, true> : early_walk_kernel<true, false>;
  return vec ? early_walk_kernel<false, true> : early_walk_kernel<false, false>;
}

size_t smem_bytes(int m) { return static_cast<size_t>(m) * sizeof(float); }

cudaError_t prepare(Kernel kern, int m) {
  const size_t smem = smem_bytes(m);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// series (N, m) float32, leaf_start and leaf_size (L,) int64, q (m,)
// float32, d_lb and d_F (L,) float32, order (L,) int64 with entries in
// [0, L), all contiguous; ctl (CTL + 2 * RING) int32 zeroed, ring_f (RING *
// (2 + k)) float32, ring_i (RING * k) int64 -> topk_d (k) float32, topk_i (k)
// int64, counts (3) int32.  A leaf is cpl items of ch rows (cpl a power of
// two <= 32); vec: m % 4 == 0 and series and q 16-byte aligned.
extern "C" int early_walk(const void* series, const void* leaf_start,
                          const void* leaf_size, const void* q,
                          const void* d_lb, const void* d_F,
                          const void* order, void* topk_d, void* topk_i,
                          void* counts, void* ctl, void* ring_f, void* ring_i,
                          int L, int m, int k, int ch, int cpl, int vec,
                          void* stream) {
  if (k <= 0 || L < 0 || m <= 0 || ch <= 0 || cpl <= 0 || cpl > 32 ||
      (cpl & (cpl - 1)) != 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(series),
               static_cast<const long long*>(leaf_start),
               static_cast<const long long*>(leaf_size),
               static_cast<const float*>(q),
               static_cast<const float*>(d_lb),
               static_cast<const float*>(d_F),
               static_cast<const long long*>(order),
               static_cast<float*>(topk_d),
               static_cast<long long*>(topk_i),
               static_cast<int*>(counts),
               static_cast<int*>(ctl),
               static_cast<float*>(ring_f),
               static_cast<long long*>(ring_i),
               L,
               m,
               k,
               ch,
               cpl};
  const Kernel kern = pick(k, vec);
  cudaError_t err = prepare(kern, m);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hopper::sm_count());
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(m);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the launch's layout for k and vec: out = {blocks, threads a block,
// registers a thread, ring slots}
extern "C" int early_walk_layout(int k, int vec, int* out) {
  const Kernel kern = pick(k, vec);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  out[0] = hopper::sm_count();
  out[1] = THREADS;
  out[2] = attr.numRegs;
  out[3] = RING;
  return cudaSuccess;
}
