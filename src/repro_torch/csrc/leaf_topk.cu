// The compact engine's candidate pass for Hopper (sm_90a): for each (query,
// survivor leaf) pair, the kk smallest distances from the query to the
// leaf's rows and their row ids.  One warp scores one pair.
//
// Replaces no Pallas kernel: in the reference the pass is a jitted
// lax.fori_loop over leaf chunks whose gather, batched product and top_k XLA
// fuses (src/repro/core/engine.py:271 _bucket_leaf_topk), called from the
// probe (:540) and from each survivor bucket (:624).  Here the whole batch is
// one launch: query q's survivors are leaves[q, 0 .. counts[q]) (ascending
// lower bound; entries outside [0, L) are padding and skipped), and each
// pair's rows are read straight from series (no slab in memory).  For each
// row s of the leaf (leaf_start[leaf] .. + leaf_size[leaf]):
//   matmul:  sqrt(max((|q|^2 + |s|^2) - 2 q.s, 0))
//   direct:  sqrt(sum (s - q)^2)
// in float32.  The kk smallest go to out row (q, leaf) (scatter: the engine's
// (Q, L+1, kk) summaries) or (q, slot) (the probe), ascending, ties to the
// lower row as the plain version's stable sort and lax.top_k give them;
// slots past the leaf's size hold (+inf, -1).  Ids are int64 row indices
// into series, as the replay kernel takes them.  Rows enter in order and
// only below the running kk-th value, so a NaN distance never enters (the
// plain version would keep it last, id -1): finite series give none.
//
// Bound on an H100 (a DSTree batch of 1M x 256 at k = 5, target 0.99: 806.9
// survivors a query, 256 queries, ~244 rows a leaf): if each pair reads its
// rows from HBM, 206,566 x 244 x 1 KB = 51.6 GB, 15.4 ms at 3.35 TB/s; the
// rows of a leaf read once for every query that keeps it, at most the
// series (1.02 GB, 0.31 ms), and the products 25.8 GFLOP, 0.39 ms at the
// 67 TFLOP/s float32 peak.
//
// Design (the simple one: a pair reads its rows itself, through L2):
//   * The pairs come leaf-major (pair_order: the slots to compute in
//     ascending leaf id, a stable argsort the wrapper makes, every other
//     slot last), so the warps in flight score the same few leaves for
//     many queries and most row reads hit L2 (one H100: 18.5 ms slot-major
//     -> 11.7 ms for a DSTree-sized batch).  They are spread over a grid
//     sized to the SMs' occupancy, a warp walking its pairs with a grid
//     stride; a warp stops at its first slot with nothing to compute (past
//     its count, or an id outside [0, L)), since all later slots are such
//     slots too.
//   * A step scores 32 rows: each lane reads its 16 bytes of every row
//     (a warp reads 512 contiguous bytes a row, 32 rows' loads in flight),
//     for any m: a column block of 128 floats a pass, masked at the end;
//     m % 4 != 0 or a misaligned pointer reads one float a lane instead.
//     Each lane sums its columns for all 32 rows; a transpose-reduce (31
//     shuffles) leaves row i's total on lane i.
//   * The top-kk (warp_topk.cuh) lives in registers across the lanes for
//     kk <= 32, and in the output row beyond (any kk up to the leaf size);
//     a ballot finds the step's rows below the kk-th value, inserted in row
//     order.
// The design that stages a leaf's rows once in shared memory for all the
// queries that keep it (the 0.4 ms bound) is not built.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "warp_topk.cuh"

namespace {

constexpr int WARPS = 4;                 // pairs in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 32;                 // rows a step, one per lane
constexpr int REG_MAX_K = 32;            // top-kk in registers up to this kk
constexpr unsigned FULL = 0xffffffffu;

// v[i] summed over the warp's lanes lands on lane i: each halving step keeps
// one half of the rows and sends the other to the partner lane (template
// steps, so every index is a constant and v stays in registers)
template <int S>
__device__ __forceinline__ void transpose_step(float (&v)[ROWS], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, S);
  }
  if constexpr (S > 1) transpose_step<S / 2>(v, lane);
}

__device__ __forceinline__ float transpose_sum(float (&v)[ROWS], int lane) {
  transpose_step<ROWS / 2>(v, lane);
  return v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
  return v;
}

// one column's terms for row r: q.s and |s|^2, or (s - q)^2
template <bool MATMUL>
__device__ __forceinline__ void add_terms(float& a, float& b, float q,
                                          float s) {
  if (MATMUL) {
    a = fmaf(q, s, a);
    b = fmaf(s, s, b);
  } else {
    const float t = s - q;
    a = fmaf(t, t, a);
  }
}

// the distance of row `lane` of the step's n rows (rows: its first row)
template <bool MATMUL, bool VEC>
__device__ __forceinline__ float step_distance(const float* __restrict__ rows,
                                               int n,
                                               const float* __restrict__ q,
                                               int m, float qn, int lane) {
  float a[ROWS], b[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    a[r] = 0.f;
    b[r] = 0.f;
  }
  if (VEC) {
    for (int c = 4 * lane; c < m; c += 4 * 32) {
      const float4 qv = __ldg(reinterpret_cast<const float4*>(q + c));
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < n) {
          const float4 s = __ldg(
              reinterpret_cast<const float4*>(rows + (long long)r * m + c));
          add_terms<MATMUL>(a[r], b[r], qv.x, s.x);
          add_terms<MATMUL>(a[r], b[r], qv.y, s.y);
          add_terms<MATMUL>(a[r], b[r], qv.z, s.z);
          add_terms<MATMUL>(a[r], b[r], qv.w, s.w);
        }
      }
    }
  } else {
    for (int c = lane; c < m; c += 32) {
      const float qv = __ldg(q + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < n)
          add_terms<MATMUL>(a[r], b[r], qv, __ldg(rows + (long long)r * m + c));
      }
    }
  }
  const float sa = transpose_sum(a, lane);
  if (!MATMUL) return sqrtf(sa);
  const float sb = transpose_sum(b, lane);
  return sqrtf(fmaxf((qn + sb) - 2.f * sa, 0.f));
}

// Blocks an SM each instance asks ptxas for (its register cap): the matmul
// form's two 32-row sums sit in 128 registers (four blocks); the direct
// form's one sum, with 16-byte loads, in 72 (seven blocks, 28 warps: left at
// 89 registers it got five, and its largest call on one H100 ran 16.3 ms
// against 13.1 at 70); the output-row top-kk (kk > 32, off the batch path)
// needs more, so its instances ask for two (255).
constexpr int min_blocks(bool matmul, bool vec, bool reg) {
  return !reg ? 2 : (!matmul && vec) ? 7 : 4;
}

template <bool MATMUL, bool VEC, bool REG>
__global__ void __launch_bounds__(THREADS, min_blocks(MATMUL, VEC, REG))
leaf_topk_kernel(const float* __restrict__ series,
                 const long long* __restrict__ leaf_start,
                 const long long* __restrict__ leaf_size,
                 const float* __restrict__ queries,
                 const long long* __restrict__ leaves,
                 const long long* __restrict__ counts,
                 const long long* __restrict__ pair_order, float* out_d,
                 long long* out_i, int Q, int C, int L, int m, int kk,
                 long long out_rows, int scatter) {
  const int lane = threadIdx.x % 32;
  const long long n_warps = (long long)gridDim.x * WARPS;
  const long long total = (long long)Q * C;
  for (long long p = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       p < total; p += n_warps) {
    const long long flat = __ldg(pair_order + p);
    const int c = (int)(flat % C);
    const int q = (int)(flat / C);
    const long long leaf =
        c < __ldg(counts + q) ? __ldg(leaves + (long long)q * C + c) : L;
    // the whole warp: the slots to compute come first
    if (leaf < 0 || leaf >= L) break;
    const long long start = __ldg(leaf_start + leaf);
    const long long size = __ldg(leaf_size + leaf);
    const long long slot = (long long)q * out_rows + (scatter ? leaf : c);
    float* od = out_d + slot * kk;
    long long* oi = out_i + slot * kk;
    const float* qr = queries + (long long)q * m;
    float qn = 0.f;
    if (MATMUL) {
      for (int j = lane; j < m; j += 32) qn = fmaf(qr[j], qr[j], qn);
      qn = warp_sum(qn);
    }
    TopK<REG> top(od, oi, kk, lane);
    for (long long r0 = 0; r0 < size; r0 += ROWS) {
      const int n = (int)(size - r0 < ROWS ? size - r0 : ROWS);
      const float d = step_distance<MATMUL, VEC>(series + (start + r0) * m, n,
                                                 qr, m, qn, lane);
      unsigned enter = __ballot_sync(FULL, lane < n && d < top.bsf);
      while (enter) {
        const int e = __ffs(enter) - 1;
        enter &= enter - 1;
        const float v = __shfl_sync(FULL, d, e);
        if (v < top.bsf) top.insert(v, start + r0 + e);  // the bsf may fall
      }
    }
    top.store(od, oi);
  }
}

template <bool MATMUL, bool VEC, bool REG>
cudaError_t launch(const float* series, const long long* leaf_start,
                   const long long* leaf_size, const float* queries,
                   const long long* leaves, const long long* counts,
                   const long long* pair_order, float* out_d,
                   long long* out_i, int Q, int C, int L, int m, int kk,
                   long long out_rows, int scatter, cudaStream_t stream) {
  const auto kernel = leaf_topk_kernel<MATMUL, VEC, REG>;
  // the grid that fills the card, asked once (the first call, before any
  // CUDA-graph capture): the port runs on one card
  static long long fill = 0;
  if (fill == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  0);
    fill = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = ((long long)Q * C + WARPS - 1) / WARPS;
  const unsigned blocks = (unsigned)(want < fill ? want : fill);
  kernel<<<blocks, THREADS, 0, stream>>>(series, leaf_start, leaf_size,
                                         queries, leaves, counts, pair_order,
                                         out_d, out_i, Q, C, L, m, kk,
                                         out_rows, scatter);
  return cudaGetLastError();
}

template <bool MATMUL>
cudaError_t launch_impl(bool vec, bool reg, const float* series,
                        const long long* leaf_start,
                        const long long* leaf_size, const float* queries,
                        const long long* leaves, const long long* counts,
                        const long long* pair_order, float* out_d,
                        long long* out_i, int Q, int C, int L, int m, int kk,
                        long long out_rows, int scatter, cudaStream_t stream) {
  auto go = [&](auto vec_t, auto reg_t) {
    return launch<MATMUL, decltype(vec_t)::value, decltype(reg_t)::value>(
        series, leaf_start, leaf_size, queries, leaves, counts, pair_order,
        out_d, out_i, Q, C, L, m, kk, out_rows, scatter, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (vec) return reg ? go(T{}, T{}) : go(T{}, F{});
  return reg ? go(F{}, T{}) : go(F{}, F{});
}

}  // namespace

// series (N, m) float32, leaf_start and leaf_size (L,) int64 (a leaf's rows
// inside series), queries (Q, m) float32, leaves (Q, C) int64 and counts
// (Q,) int64 and pair_order (Q x C,) int64, all contiguous: a permutation
// of the flat slots q x C + c, the order the warps take them in, with every
// slot to compute (below its count, leaf id in [0, L)) ahead of every other
// slot; out_d (Q, out_rows, kk) float32 and out_i
// (Q, out_rows, kk) int64, contiguous, written only at the pairs' rows
// (leaf if scatter, else slot).  matmul: 1 for the matmul form, 0 for the
// direct one.
extern "C" int leaf_topk(const void* series, const void* leaf_start,
                         const void* leaf_size, const void* queries,
                         const void* leaves, const void* counts,
                         const void* pair_order, void* out_d, void* out_i,
                         int Q, int C, int L, int m, int kk,
                         long long out_rows, int scatter, int matmul,
                         void* stream) {
  if (Q <= 0 || C <= 0) return cudaGetLastError();
  if (m <= 0 || kk <= 0 || L < 0) return cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(series) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const bool reg = kk <= REG_MAX_K;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(series);
  const auto* ls = static_cast<const long long*>(leaf_start);
  const auto* lz = static_cast<const long long*>(leaf_size);
  const auto* qs = static_cast<const float*>(queries);
  const auto* lv = static_cast<const long long*>(leaves);
  const auto* ct = static_cast<const long long*>(counts);
  const auto* po = static_cast<const long long*>(pair_order);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<long long*>(out_i);
  if (matmul)
    return launch_impl<true>(vec, reg, s, ls, lz, qs, lv, ct, po, od, oi, Q,
                             C, L, m, kk, out_rows, scatter, st);
  return launch_impl<false>(vec, reg, s, ls, lz, qs, lv, ct, po, od, oi, Q, C,
                            L, m, kk, out_rows, scatter, st);
}
