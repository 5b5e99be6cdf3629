// The exact cascade replay for Hopper (sm_90a): one warp walks one row.
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
// d_lb and d_F (4 each); a searched position also its kk values.  At a
// DSTree batch (256 x 4096) that is 16.8 MB, 5 us at 3.35 TB/s.  The walk
// itself is a chain of dependent steps per row, so latency, not bytes, sets
// the time: a step's gathers cannot start before its order entries arrive,
// and a merge decides the bsf the next position is tested against.
//
// Design:
//   * One warp per row, 2 rows a block (a batch's 256 rows spread over the
//     SMs, and a row's d_lb and d_F stay in its SM's L1); each step takes
//     4 x 32 positions, one per lane and chunk: the order entries are
//     loaded one step ahead, then the 8 gathers of d_lb and d_F go out
//     together.
//   * bsf never rises, so a position pruned at the chunk's starting bsf
//     stays pruned whatever happens before it in the chunk.  Each 32-chunk
//     is pre-tested lane-parallel against that bsf; only the others (the
//     candidates, found by a ballot) are walked one by one, each tested
//     against the current bsf.  Afterwards every lane classifies its
//     position from the bsf just before it (the bsf after the chunk's last
//     candidate before it), counted by ballots.
//   * A searched leaf's slots enter in slot order while they lie below the
//     bsf (each insertion goes after every entry <= it and drops the last:
//     the stable merge's order).  Up to kk = 8 (every batch's k <= 5 and
//     calibration's 1) each candidate lane loads its leaf's slots right
//     after the pre-test, all candidates' loads in flight together, and the
//     walk takes them by shuffles; a larger kk is loaded 32 slots at a time
//     when its leaf is searched, and a ballot finds the slots below the bsf.
//   * The top-k lives in registers across the lanes for k <= 32 (lane i
//     holds entry i; an insertion is a ballot and a shuffle), and for larger
//     k in the row's output buffer (L1/L2-resident; an insertion counts the
//     entries <= it across the lanes and shifts the tail up 32 at a time):
//     TopK in warp_topk.cuh, shared with the candidate-pass kernel.
//   ref.py's replay_chunked emulates this walk for the CPU tests.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "warp_topk.cuh"

namespace {

constexpr int WARPS = 2;                 // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 4;                   // 32-position chunks per step
constexpr int STEP = 32 * SUB;
constexpr int REG_MAX_K = 32;            // top-k in registers up to this k
constexpr int PRE = 8;                   // leaf slots a candidate preloads
constexpr unsigned FULL = 0xffffffffu;

// a searched leaf's kk <= PRE slots, preloaded by its lane j, into the top-k
template <bool REG>
__device__ __forceinline__ void merge_preloaded(TopK<REG>& top,
                                                const float (&v)[PRE],
                                                const long long (&vi)[PRE],
                                                int kk, int j) {
#pragma unroll
  for (int t = 0; t < PRE; ++t) {
    if (t >= kk) break;
    const float ve = __shfl_sync(FULL, v[t], j);
    if (ve < top.bsf) top.insert(ve, __shfl_sync(FULL, vi[t], j));
  }
}

// a searched leaf's kk slots into the top-k, in slot order
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

template <bool REG>
__global__ void __launch_bounds__(THREADS)
replay_kernel(const float* __restrict__ leaf_d,
              const long long* __restrict__ leaf_i, long long row_stride,
              const float* __restrict__ d_lb, const float* __restrict__ d_F,
              const long long* __restrict__ order, float* topk_d,
              long long* topk_i, int* __restrict__ n_s,
              int* __restrict__ n_plb, int* __restrict__ n_pf, int Q, int L,
              int kk, int k) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= Q) return;                    // the whole warp
  const long long* ord = order + (long long)r * L;
  const float* lbr = d_lb + (long long)r * L;
  const float* fr = d_F + (long long)r * L;
  const float* ldr = leaf_d + r * row_stride;
  const long long* lir = leaf_i + r * row_stride;
  TopK<REG> top(topk_d + (long long)r * k, topk_i + (long long)r * k, k,
                lane);
  int plb = 0, pf = 0;

  long long next[SUB];
#pragma unroll
  for (int s = 0; s < SUB; ++s) {
    const int p = s * 32 + lane;
    next[s] = p < L ? __ldg(ord + p) : 0;
  }
  for (int p0 = 0; p0 < L; p0 += STEP) {
    long long o[SUB];
    float lb[SUB], f[SUB];
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      o[s] = next[s];
      const int p = p0 + STEP + s * 32 + lane;
      next[s] = p < L ? __ldg(ord + p) : 0;
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      const bool ok = p0 + s * 32 + lane < L;
      lb[s] = ok ? __ldg(lbr + o[s]) : 0.f;
      f[s] = ok ? __ldg(fr + o[s]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      const bool ok = p0 + s * 32 + lane < L;
      const float bsf0 = top.bsf;
      const bool mine = ok && !(lb[s] > bsf0) && !(f[s] > bsf0);
      unsigned cand = __ballot_sync(FULL, mine);
      // every candidate's slots load at once, before the walk needs them
      float v[PRE];
      long long vi[PRE];
#pragma unroll
      for (int t = 0; t < PRE; ++t) {
        const bool load = mine && t < kk && kk <= PRE;
        v[t] = load ? __ldg(ldr + o[s] * kk + t) : 0.f;
        vi[t] = load ? __ldg(lir + o[s] * kk + t) : 0;
      }
      float seen = bsf0;                 // the bsf just before this position
      while (cand) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        const float lbj = __shfl_sync(FULL, lb[s], j);
        const float fj = __shfl_sync(FULL, f[s], j);
        const long long oj = __shfl_sync(FULL, o[s], j);
        if (!(lbj > top.bsf) && !(fj > top.bsf)) {
          if (kk <= PRE)
            merge_preloaded<REG>(top, v, vi, kk, j);
          else
            merge_leaf<REG>(top, ldr + oj * kk, lir + oj * kk, kk, lane);
        }
        if (lane > j) seen = top.bsf;
      }
      const bool by_lb = ok && lb[s] > seen;
      const bool by_f = ok && !(lb[s] > seen) && f[s] > seen;
      plb += __popc(__ballot_sync(FULL, by_lb));
      pf += __popc(__ballot_sync(FULL, by_f));
    }
  }
  top.store(topk_d + (long long)r * k, topk_i + (long long)r * k);
  if (lane == 0) {
    n_plb[r] = plb;
    n_pf[r] = pf;
    n_s[r] = L - plb - pf;
  }
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
  const unsigned blocks = (Q + WARPS - 1) / WARPS;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ld = static_cast<const float*>(leaf_d);
  const auto* li = static_cast<const long long*>(leaf_i);
  const auto* lb = static_cast<const float*>(d_lb);
  const auto* f = static_cast<const float*>(d_F);
  const auto* o = static_cast<const long long*>(order);
  auto* td = static_cast<float*>(topk_d);
  auto* ti = static_cast<long long*>(topk_i);
  auto* s = static_cast<int*>(n_s);
  auto* plb = static_cast<int*>(n_plb);
  auto* pf = static_cast<int*>(n_pf);
  if (k <= REG_MAX_K)
    replay_kernel<true><<<blocks, THREADS, 0, st>>>(
        ld, li, row_stride, lb, f, o, td, ti, s, plb, pf, Q, L, kk, k);
  else
    replay_kernel<false><<<blocks, THREADS, 0, st>>>(
        ld, li, row_stride, lb, f, o, td, ti, s, plb, pf, Q, L, kk, k);
  return cudaGetLastError();
}
