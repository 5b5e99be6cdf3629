// The compact engine's candidate pass for Hopper (sm_90a): for each (query,
// survivor leaf) pair, the kk smallest distances from the query to the
// leaf's rows and their row ids.  Two instances, chosen before launch by the
// call's shapes alone (kernels/leaf_topk/kernel.py `instance`):
//   leaf_topk_wgmma_kernel  the batch's survivor pass (scatter) in the
//                           matmul form with m % 4 == 0, 16-byte-aligned
//                           series and queries, kk <= 32: a leaf's rows
//                           staged once by TMA for up to 64 of the queries
//                           that keep it, the products on split-TF32 wgmma;
//   leaf_topk_kernel        every other call (the probe, the direct form,
//                           m % 4 != 0, kk > 32): one warp a pair.
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
// Bound on an H100 (the largest call of a run, iSAX exact at k = 5: 404,258
// pairs, 54.9M pair-rows of m = 256; a DSTree batch at k = 5, 0.99 is about
// half of it): if each pair reads its rows from HBM, 56 GB, 16.8 ms at 3.35
// TB/s; the rows of a leaf read once for every query that keeps it, at most
// the series (1.02 GB), 0.32 ms; the products 28 GFLOP, 0.43 ms at the 67
// TFLOP/s float32 peak, 0.17 ms as three split-TF32 passes at 495 TFLOP/s.
// The staged instance aims at the rows-once bound (bytes).
//
// The staged instance (leaf_topk_wgmma_kernel):
//   * Items.  The wrapper sorts the slots to compute leaf-major (stable:
//     queries ascending within a leaf) and gives each leaf's first pair in
//     that order (`bounds`, L + 1), the running count of its groups of 64
//     queries (`item_end`, L) and each item's leaf (`item_leaf`, a
//     searchsorted over item_end), all on the device: the call needs no host
//     sync.  An item is one leaf with up to 64 of the queries that keep it.
//     Persistent blocks, one per SM, take items i, i + grid, ...
//   * A block is two pipelines, each a producer half (two warps of
//     warpgroup 0) and a consumer warpgroup (1 or 2) with a ring of its own
//     (three stages, one at kk > 7), taking alternate items of the block, so
//     one pipeline's epilogue overlaps the other's products.  The producer
//     half's thread 0 loads each stage, 32 columns x 128 rows of the leaf
//     (two 64-row boxes; one for a last tile of <= 64 rows), by TMA from a
//     2-D map over the whole series (128-byte swizzle, the K-major B layout
//     desc_sw128 reads; columns past m and rows past the series are
//     zero-filled), as far ahead as the ring's free slots allow, behind
//     mbarriers.  Then each of its 64 threads takes two rows of the arrived
//     stage, writes lo = x - trunc(x) beside each (the tensor cores read the
//     raw row as its hi: they drop a float32 operand's 13 low bits) and adds
//     the row's squares to its |s|^2, in float32.  No copy of the series is
//     made in device memory.
//   * The consumer: D (64 queries x 128 rows) = A.B^T by wgmma m64n128k8
//     .tf32 (n64 for a last tile of <= 64 rows), A = the item's queries,
//     read from global memory (L1/L2) and split in registers (hi rounded, lo
//     the truncated rest), B = the staged rows and their lo; three products
//     a k8 step, the small ones first (a_lo.x_hi, a_hi.x_lo, a_hi.x_hi).
//     Each 32-column stage is summed on the tensor cores from zero and added
//     to a float32 total to nearest, as pairwise_l2 sums (summed over all of
//     m on the tensor cores, each step's rounding toward zero drifts several
//     times closer to the limit at m = 256, in the CPU emulation).  |q|^2
//     comes from the A fragments in float32.
//   * Epilogue.  A thread holds 2 queries x 32 rows of a tile (hopper.cuh's
//     D layout: a query's rows on one lane quad).  It computes their
//     distances, +inf past the leaf's end, and keeps for each of its two
//     queries the kk smallest (value, row) of its rows, in row order (equal
//     values stay in row order), across the leaf's tiles: for kk <= 8 in
//     registers during a tile (an instance for each kk; an insertion is a
//     branch-free shift, since a branch that parts the lanes of a warp costs
//     every lane), in shared memory between tiles; for kk > 8 in shared
//     memory.  After the last tile each lane places its own entries in the
//     output row at their rank among the quad's four lists (smallest
//     (value, row) first): ascending, ties to the lower row, (+inf, -1) past
//     the leaf's size, as the plain version.
//
// The warp instance (leaf_topk_kernel, the simple design):
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

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"
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

// ---- the staged instance: TMA-fed leaf tiles, split-TF32 wgmma -----------

namespace staged {

constexpr int G = 64;                   // queries an item: one m64 tile
constexpr int TN = 128;                 // rows a tile: wgmma n128
constexpr int BOX = 64;                 // rows a TMA box, and an n64 tile
constexpr int TK = 32;                  // columns a stage: a 128-byte line
constexpr int CONSUMERS = 2;            // pipelines: a producer half and a
                                        // consumer warpgroup each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int HALF = TN * TK * 4;       // a stage's raw rows (or lo): 16 KB
constexpr int SLOT = 2 * HALF;
constexpr int MAX_RING = 3;             // stages a pipeline's ring
constexpr int SMEM_MAX = 232448;        // a block's shared memory on an H100
constexpr int MAX_KK = REG_MAX_K;       // the kk this instance takes
// the lists sit in registers during a tile for kk <= REG_LIST, in an
// instance for each kk with lists of exactly kk entries: longer lists with
// the entries past kk masked measured slower at kk = 1 and 5 on an H100
// (bench/leaf_topk_lists.py, whose scratch copies define
// LEAF_TOPK_ONE_LIST: one instance of that many entries for every kk up to
// it; PERF.md)
constexpr int REG_LIST = 8;
#ifdef LEAF_TOPK_ONE_LIST
static_assert(LEAF_TOPK_ONE_LIST >= 1 && LEAF_TOPK_ONE_LIST <= MAX_KK,
              "a register instance");
#endif

struct Bars {
  uint64_t raw[CONSUMERS * MAX_RING];   // the stage's TMA bytes landed
  uint64_t full[CONSUMERS * MAX_RING];  // its lo and |s|^2 are written
  uint64_t empty[CONSUMERS * MAX_RING]; // its consumer has read it
};

// the consumers' lists: two a thread (one a query), kk (value, row) each
constexpr int list_bytes(int kk) { return CONSUMERS * 2 * kk * 128 * 8; }

// each pipeline's ring: as many stages as shared memory holds beside the
// lists, up to MAX_RING
constexpr int ring_stages(int kk) {
  return (SMEM_MAX - 1024 - (int)sizeof(Bars) - list_bytes(kk)) /
                     (CONSUMERS * (SLOT + TN * 4)) < MAX_RING
             ? (SMEM_MAX - 1024 - (int)sizeof(Bars) - list_bytes(kk)) /
                   (CONSUMERS * (SLOT + TN * 4))
             : MAX_RING;
}

constexpr int smem_bytes(int kk) {
  return CONSUMERS * ring_stages(kk) * (SLOT + TN * 4) + list_bytes(kk) +
         (int)sizeof(Bars) + 1024;
}
static_assert(ring_stages(MAX_KK) >= 1, "a stage a pipeline at kk = 32");
static_assert(smem_bytes(MAX_KK) <= SMEM_MAX, "227 KB a block");

struct Args {
  const long long* leaf_start;
  const long long* leaf_size;
  const float* queries;
  const long long* pair_order;          // the slots to compute, leaf-major
  const long long* bounds;              // (L + 1,) each leaf's first pair
  const long long* item_end;            // (L,) running count of groups
  const long long* item_leaf;           // each item's leaf
  float* out_d;
  long long* out_i;
  long long out_rows;
  int C, L, m, kk, nsr;
};

// an item: a leaf and up to G of the queries that keep it
struct Item {
  long long leaf, start, size, pair0;
  int nq, tiles;
};

// x as lane 0 of the warp has it: a value the whole warpgroup computes
// alike, made warp-uniform for the compiler (a wgmma under a branch it cannot
// prove uniform is serialized)
template <typename T>
__device__ __forceinline__ T uniform(T x) {
  return __shfl_sync(FULL, x, 0);
}

__device__ __forceinline__ long long n_items(const Args& a) {
  return uniform(__ldg(a.item_end + a.L - 1));
}

__device__ __forceinline__ Item item_at(const Args& a, long long i) {
  const int lo = (int)__ldg(a.item_leaf + i);
  Item it;
  it.leaf = lo;
  const long long first = lo > 0 ? __ldg(a.item_end + lo - 1) : 0;
  it.pair0 = __ldg(a.bounds + lo) + (i - first) * G;
  const long long left = __ldg(a.bounds + lo + 1) - it.pair0;
  it.nq = (int)(left < G ? left : G);
  it.start = __ldg(a.leaf_start + lo);
  it.size = __ldg(a.leaf_size + lo);
  it.tiles = (int)((it.size + TN - 1) / TN);
  return it;
}

// a producer half's cursor over its pipeline's stages, in order: item (the
// block's every other item; items of an empty leaf have none), row tile,
// 32-column stage
struct Walk {
  long long item, start, size, step;
  int tile, ks, tiles;

  __device__ void enter(const Args& a, long long n) {
    for (; item < n; item += step) {
      const Item it = item_at(a, item);
      if (it.tiles > 0) {
        start = it.start, size = it.size, tiles = it.tiles;
        tile = 0, ks = 0;
        return;
      }
    }
  }
  __device__ void next(const Args& a, long long n, int ks_n) {
    if (++ks < ks_n) return;
    ks = 0;
    if (++tile < tiles) return;
    item += step;
    enter(a, n);
  }
  // the tile's staged rows: two boxes, or one for a last tile of <= BOX
  __device__ int rows() const {
    return size - (long long)tile * TN > BOX ? TN : BOX;
  }
};

__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// A producer half (warpgroup 0's warps 2h and 2h + 1) feeds pipeline h's
// ring: its thread 0 loads the stages by TMA, as far ahead as the ring's
// free slots allow (it waits only for the slot of the stage about to be
// split); then each of its 64 threads takes two rows of the arrived stage:
// lo = x - trunc(x) beside each, and the row's squares added to |s|^2
// (float32, four partial sums by column mod 4), stored with the tile's last
// stage
__device__ __forceinline__ void produce(const CUtensorMap* map, const Args& a,
                                        char* smem, float* sn_all,
                                        Bars& bars, int h, int ptid) {
  const long long n = n_items(a);
  const int ks_n = (a.m + TK - 1) / TK;
  const int nsr = a.nsr, s0 = h * nsr;
  Walk iss, spl;
  iss.item = spl.item = blockIdx.x + (long long)h * gridDim.x;
  iss.step = spl.step = (long long)CONSUMERS * gridDim.x;
  iss.enter(a, n);
  spl.enter(a, n);
  long long p_iss = 0;
  float ssq[2][4] = {};
  for (long long p = 0; spl.item < n; ++p) {
    if (ptid == 0) {
      // position p must be issued (waiting for its slot if need be); the
      // ones after it, as far as their slots are free already
      for (; iss.item < n && p_iss < p + nsr; ++p_iss) {
        const int slot = s0 + (int)(p_iss % nsr);
        const uint32_t parity = (uint32_t)((p_iss / nsr) & 1) ^ 1u;
        if (p_iss <= p)
          hopper::mbar_wait(&bars.empty[slot], parity);
        else if (!hopper::mbar_test(&bars.empty[slot], parity))
          break;
        const int boxes = iss.rows() / BOX;
        char* dst = smem + slot * SLOT;
        hopper::mbar_arrive_tx(&bars.raw[slot], boxes * BOX * TK * 4);
        const int y = (int)(iss.start + (long long)iss.tile * TN);
        for (int b = 0; b < boxes; ++b)
          hopper::tma_load_2d(dst + b * BOX * 128, map, &bars.raw[slot],
                              iss.ks * TK, y + b * BOX);
        iss.next(a, n, ks_n);
      }
    }
    const int slot = s0 + (int)(p % nsr);
    hopper::mbar_wait(&bars.raw[slot], (uint32_t)((p / nsr) & 1));
    char* raw = smem + slot * SLOT;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = ptid + 64 * rr;
      if (r < spl.rows()) {
#pragma unroll 4
        for (int c = 0; c < TK / 4; ++c) {
          const uint32_t off = r * 128u + ((c ^ (r & 7)) << 4);
          const float4 x = *reinterpret_cast<const float4*>(raw + off);
          const float4 lo = make_float4(x.x - trunc_tf32(x.x),
                                        x.y - trunc_tf32(x.y),
                                        x.z - trunc_tf32(x.z),
                                        x.w - trunc_tf32(x.w));
          *reinterpret_cast<float4*>(raw + HALF + off) = lo;
          ssq[rr][0] = fmaf(x.x, x.x, ssq[rr][0]);
          ssq[rr][1] = fmaf(x.y, x.y, ssq[rr][1]);
          ssq[rr][2] = fmaf(x.z, x.z, ssq[rr][2]);
          ssq[rr][3] = fmaf(x.w, x.w, ssq[rr][3]);
        }
        if (spl.ks == ks_n - 1) {
          sn_all[slot * TN + r] =
              (ssq[rr][0] + ssq[rr][1]) + (ssq[rr][2] + ssq[rr][3]);
          ssq[rr][0] = ssq[rr][1] = ssq[rr][2] = ssq[rr][3] = 0.f;
        }
      }
    }
    hopper::fence_proxy_async();        // lo is read by the tensor cores
    __syncwarp();
    if ((ptid & 31) == 0) hopper::mbar_arrive(&bars.full[slot]);
    spl.next(a, n, ks_n);
  }
}

// a consumer thread's two queries (rows 16w + g and + 8 of the item's m64
// tile), their |q|^2, and its two lists in shared memory: list j (query
// j's kk smallest (value, row) of the thread's rows so far, ascending,
// equal values in row order) has entry e at ld[(j * kk + e) * 128], the
// warpgroup's threads side by side; bsf[j], its kk-th value, gates it
struct Cons {
  const float* qp[2];
  float qn[2], bsf[2];
  float* ld;
  int* lr;
  int kk;
};

// where an item's results go: query j's output row (out_d / out_i + o[j]),
// for the group's real rows (ok[j])
struct Out {
  float* out_d;
  long long* out_i;
  long long o[2], start;
  bool ok[2];
};

// (value, row) as one key ordered as the pair: values are >= 0 or +inf
__device__ __forceinline__ unsigned long long pair_key(float v, int row) {
  return (unsigned long long)__float_as_uint(v) << 32 | (unsigned)row;
}

// v < st.bsf[j]: v goes after every entry <= v, the last drops out
__device__ __forceinline__ void insert_smem(Cons& st, int j, float v,
                                            int row) {
  float* d = st.ld + j * st.kk * 128;
  int* r = st.lr + j * st.kk * 128;
  int e = st.kk - 1;
  for (; e > 0; --e) {
    const float prev = d[(e - 1) * 128];
    if (prev <= v) break;
    d[e * 128] = prev;
    r[e * 128] = r[(e - 1) * 128];
  }
  d[e * 128] = v;
  r[e * 128] = row;
  st.bsf[j] = d[(st.kk - 1) * 128];
}

// the two lists in registers for one tile's insertions (K entries, kk <=
// K; loaded from and stored back to the shared-memory lists, so they hold
// no registers through the products).  push<J> inserts into list J without
// a branch or a gate: each entry takes its upper neighbour, v, or stays, so
// a value at or above the kk-th entry changes only the entries past kk,
// which are never stored
template <int K>
struct RegLists {
  float d[2][K];
  int r[2][K];

  __device__ __forceinline__ void load(const Cons& st) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const bool in = e < st.kk;
        d[j][e] = in ? st.ld[(j * st.kk + e) * 128] : INFINITY;
        r[j][e] = in ? st.lr[(j * st.kk + e) * 128] : -1;
      }
  }
  __device__ __forceinline__ void store(const Cons& st) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < K; ++e)
        if (e < st.kk) {
          st.ld[(j * st.kk + e) * 128] = d[j][e];
          st.lr[(j * st.kk + e) * 128] = r[j][e];
        }
  }
  // after the item's last tile: the quad's four lists of each query merged
  // into its output row, each lane placing its own first kk entries at
  // their rank (index + the entries of the other lanes' lists before them;
  // rows differ between lanes, and the (+inf, -1) entries, which may share
  // a rank, write the same there)
  __device__ __forceinline__ void merge(const Cons& st, const Out& out,
                                        int lane) const {
    const int quad = lane & ~3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      unsigned long long key[K];
      int rank[K];
#pragma unroll
      for (int e = 0; e < K; ++e)
        key[e] = pair_key(d[j][e], r[j][e]), rank[e] = e;
#pragma unroll
      for (int u = 1; u < 4; ++u) {
        const int src = quad | ((lane + u) & 3);
#pragma unroll
        for (int f = 0; f < K; ++f) {
          const unsigned long long w = __shfl_sync(FULL, key[f], src);
          if (f < st.kk) {
#pragma unroll
            for (int e = 0; e < K; ++e) rank[e] += w < key[e];
          }
        }
      }
      if (out.ok[j]) {
#pragma unroll
        for (int e = 0; e < K; ++e)
          if (e < st.kk && rank[e] < st.kk) {
            out.out_d[out.o[j] + rank[e]] = d[j][e];
            out.out_i[out.o[j] + rank[e]] =
                d[j][e] < INFINITY ? out.start + r[j][e] : -1;
          }
      }
    }
  }
  template <int J>
  __device__ __forceinline__ void push(float v, int row) {
#pragma unroll
    for (int e = K - 1; e > 0; --e) {
      const bool up = v < d[J][e - 1], here = v < d[J][e];
      r[J][e] = up ? r[J][e - 1] : here ? row : r[J][e];
      d[J][e] = up ? d[J][e - 1] : here ? v : d[J][e];
    }
    const bool top = v < d[J][0];
    r[J][0] = top ? row : r[J][0];
    d[J][0] = top ? v : d[J][0];
  }
};

// the A fragments' columns of half a stage (two k8 steps): x[4s + e] =
// {q0[c], q1[c], q0[c + 4], q1[c + 4]}, c = c0 + 8s (c0: the half's first
// column + t)
__device__ __forceinline__ void load_half(float (&x)[8], const Cons& st,
                                          int m, int c0) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = c0 + 8 * s;
    x[4 * s + 0] = c < m ? __ldg(st.qp[0] + c) : 0.f;
    x[4 * s + 1] = c < m ? __ldg(st.qp[1] + c) : 0.f;
    x[4 * s + 2] = c + 4 < m ? __ldg(st.qp[0] + c + 4) : 0.f;
    x[4 * s + 3] = c + 4 < m ? __ldg(st.qp[1] + c + 4) : 0.f;
  }
}

// half a stage's A fragments split into hi and lo, and the queries'
// squares added to |q|^2 (no branch: the products around it stay
// asynchronous)
__device__ __forceinline__ void split_half(const float (&x)[8],
                                           uint32_t (&ah)[2][4],
                                           uint32_t (&al)[2][4], Cons& st) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tf32x3::split(x[4 * s + e], ah[s][e], al[s][e]);
    st.qn[0] = fmaf(x[4 * s], x[4 * s], st.qn[0]);
    st.qn[0] = fmaf(x[4 * s + 2], x[4 * s + 2], st.qn[0]);
    st.qn[1] = fmaf(x[4 * s + 1], x[4 * s + 1], st.qn[1]);
    st.qn[1] = fmaf(x[4 * s + 3], x[4 * s + 3], st.qn[1]);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&acc)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int keep) {
  if constexpr (N == TN)
    hopper::wgmma_n128(acc, a, desc, keep);
  else
    hopper::wgmma_n64(acc, a, desc, keep);
}

// the products of two k8 steps from k8 step s0 on, three a step, the small
// ones first; the stage's first step starts its sum from zero
template <int N>
__device__ __forceinline__ void products(float (&acc)[N / 2],
                                         const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4],
                                         uint64_t dh, uint64_t dl, int s0) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t k = 32 * (s0 + s);
    wgmma_tile<N>(acc, al[s], hopper::desc_add(dh, k), s0 + s > 0);
    wgmma_tile<N>(acc, ah[s], hopper::desc_add(dl, k), 1);
    wgmma_tile<N>(acc, ah[s], hopper::desc_add(dh, k), 1);
  }
}

// one row tile (N = 128, or 64 for a last tile of <= 64 rows) of the
// item: every stage's products summed from zero on the tensor cores, the
// stage sums added in float32; then the distances, +inf past the leaf's
// end, into the thread's two lists (K > 0: after the last tile, merged into
// the outputs from registers)
template <int N, int K>
__device__ __forceinline__ void tile_pass(const Args& a, const char* smem,
                                          const float* sn_all, Bars& bars,
                                          long long& pos, int s0, int ks_n,
                                          Cons& st, const Out& out,
                                          long long row0, long long size,
                                          bool last, int lane) {
  const int t = lane & 3;
  st.qn[0] = st.qn[1] = 0.f;            // |q|^2 again each tile, alike
  float tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
  for (int ks = 0; ks < ks_n; ++ks) {
    // the stage's query columns, half at a time (8 registers in flight)
    uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];
    float x[8];
    load_half(x, st, a.m, ks * TK + t);
    split_half(x, ah0, al0, st);
    load_half(x, st, a.m, ks * TK + 16 + t);
    split_half(x, ah1, al1, st);
    const int slot = s0 + (int)(pos % a.nsr);
    hopper::mbar_wait(&bars.full[slot], (uint32_t)((pos / a.nsr) & 1));
    hopper::fence_proxy_async();
    const char* base = smem + slot * SLOT;
    const uint64_t dh = hopper::desc_sw128(base);
    const uint64_t dl = hopper::desc_sw128(base + HALF);
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    hopper::wgmma_fence();
    products<N>(acc, ah0, al0, dh, dl, 0);
    products<N>(acc, ah1, al1, dh, dl, 2);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] += acc[i];
    if (ks == ks_n - 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {     // the quad holds all of m
        st.qn[j] += __shfl_xor_sync(FULL, st.qn[j], 1);
        st.qn[j] += __shfl_xor_sync(FULL, st.qn[j], 2);
      }
      const float* sn = sn_all + slot * TN;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sn + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1);
          const float d = sqrtf(fmaxf(
              (st.qn[e >> 1] + ((e & 1) ? s2.y : s2.x)) - 2.f * tot[4 * j + e],
              0.f));
          tot[4 * j + e] = row0 + r < size ? d : INFINITY;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&bars.empty[slot]);
    ++pos;
  }
  if constexpr (K > 0) {
    RegLists<K> lists;
    lists.load(st);
    // every row alike, a group's empty ones too (their lists are never
    // written out): a branch here measured slower
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int r = (int)row0 + 8 * j + 2 * t;
      lists.template push<0>(tot[4 * j], r);
      lists.template push<0>(tot[4 * j + 1], r + 1);
      lists.template push<1>(tot[4 * j + 2], r);
      lists.template push<1>(tot[4 * j + 3], r + 1);
    }
    if (last)
      lists.merge(st, out, lane);
    else
      lists.store(st);
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tot[4 * j + e] < st.bsf[e >> 1])
          insert_smem(st, e >> 1, tot[4 * j + e],
                      (int)(row0 + 8 * j + 2 * t + (e & 1)));
  }
}

// warpgroups 1 and 2: consumer c takes the block's items c, c + 2, ... from
// pipeline c's ring
template <int K>
__device__ __forceinline__ void consume(const Args& a, const char* smem,
                                        const float* sn_all, float* lists_d,
                                        int* lists_r, Bars& bars, int c,
                                        int ct) {
  const int lane = ct & 31, w = ct >> 5, g = lane >> 2, t = lane & 3;
  const long long n = n_items(a);
  const int ks_n = (a.m + TK - 1) / TK;
  const int kk = a.kk;
  const int list = 2 * kk * 128;
  Cons st;
  st.ld = lists_d + c * list + ct;
  st.lr = lists_r + c * list + ct;
  st.kk = kk;
  const int s0 = c * a.nsr;              // its ring's slots
  long long pos = 0;
  for (long long item = blockIdx.x + (long long)c * gridDim.x; item < n;
       item += (long long)CONSUMERS * gridDim.x) {
    const Item it = item_at(a, item);
    const int tiles = uniform(it.tiles);
    const long long size = uniform(it.size);
    bool ok[2];
    long long qi[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * w + g + 8 * j;
      ok[j] = r < it.nq;
      qi[j] = __ldg(a.pair_order + it.pair0 + (ok[j] ? r : 0)) / a.C;
      st.qp[j] = a.queries + qi[j] * a.m;
      st.bsf[j] = ok[j] ? INFINITY : -INFINITY;  // empty rows take none
      for (int e = 0; e < kk; ++e) {
        st.ld[(j * kk + e) * 128] = INFINITY;
        st.lr[(j * kk + e) * 128] = -1;
      }
    }
    Out out;
    out.out_d = a.out_d, out.out_i = a.out_i, out.start = it.start;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out.o[j] = (qi[j] * a.out_rows + it.leaf) * kk, out.ok[j] = ok[j];
    for (int tile = 0; tile < tiles; ++tile) {
      const long long row0 = (long long)tile * TN;
      if (size - row0 > BOX)
        tile_pass<TN, K>(a, smem, sn_all, bars, pos, s0, ks_n, st, out,
                         row0, size, tile == tiles - 1, lane);
      else
        tile_pass<BOX, K>(a, smem, sn_all, bars, pos, s0, ks_n, st, out,
                          row0, size, tile == tiles - 1, lane);
    }
    __syncwarp();                       // the quad's lists are written
    if (K > 0 && tiles > 0) continue;   // merged from registers
    // (K == 0, or an empty leaf) each lane of the quad places its own
    // entries of each query's list from shared memory:
    // an entry's rank is its index plus the entries of the other three
    // lanes' lists that come before it, smallest (value, row) first (rows
    // differ between lanes; the (+inf, -1) entries may share a rank, and
    // write the same there)
    const float* d4 = lists_d + c * list + (ct - t);
    const int* r4 = lists_r + c * list + (ct - t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!ok[j]) continue;
      const long long o = out.o[j];
      for (int e = 0; e < kk; ++e) {
        const float v = d4[(j * kk + e) * 128 + t];
        const int row = r4[(j * kk + e) * 128 + t];
        int rank = e;
        for (int u = 1; u < 4; ++u) {
          const int l = (t + u) & 3;
          for (int f = 0; f < kk; ++f) {
            const float w = d4[(j * kk + f) * 128 + l];
            const int rw = r4[(j * kk + f) * 128 + l];
            rank += w < v || (w == v && rw < row);
          }
        }
        if (rank < kk) {
          a.out_d[o + rank] = v;
          a.out_i[o + rank] = v < INFINITY ? it.start + row : -1;
        }
      }
    }
    __syncwarp();                       // before the next item's lists
  }
}

// K: the tiles' insertions into the lists on K-entry copies in registers
// (kk <= K), or, K == 0, in shared memory
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
leaf_topk_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                       const Args a) {
  extern __shared__ char smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  char* smem = smem_raw + pad;
  const int ns = CONSUMERS * a.nsr;
  float* sn_all = reinterpret_cast<float*>(smem + ns * SLOT);
  float* lists_d = sn_all + ns * TN;
  int* lists_r = reinterpret_cast<int*>(lists_d + CONSUMERS * 2 * a.kk * 128);
  Bars& bars =
      *reinterpret_cast<Bars*>(lists_r + CONSUMERS * 2 * a.kk * 128);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      hopper::mbar_init(&bars.raw[i], 1);
      hopper::mbar_init(&bars.full[i], 2);   // a producer half's warps
      hopper::mbar_init(&bars.empty[i], 4);  // its consumer's warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = uniform((int)threadIdx.x / 128);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    produce(&map, a, smem, sn_all, bars, uniform((int)threadIdx.x / 64),
            threadIdx.x % 64);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  consume<K>(a, smem, sn_all, lists_d, lists_r, bars, wg - 1,
             threadIdx.x - 128 * wg);
}

// the 2-D view (m, n_rows) of the series in boxes of 32 columns x 64 rows,
// 128-byte swizzle, zeros outside
cudaError_t tensor_map(CUtensorMap* map, const void* series, long long n_rows,
                       int m) {
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)m * 4};
  const cuuint32_t box[2] = {TK, BOX};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(series), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace staged

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

// The staged instance (the batch's survivor pass): series (n_rows, m)
// float32 with m % 4 == 0, 16-byte aligned, as queries (Q, m); leaf_start
// and leaf_size (L,) int64; the item table of kernels/leaf_topk/kernel.py
// `item_table`: pair_order (Q x C,) int64, the flat slots q x C + c to
// compute first, leaf-major, queries ascending within a leaf, bounds (L +
// 1,) int64 each leaf's first entry there (bounds[L]: the slots to
// compute), item_end (L,) int64 the running count of each leaf's groups of
// 64 queries, item_leaf int64 each item's leaf (entries past the items
// unread); out_d (Q, out_rows, kk) float32 and out_i int64 written at
// rows (q, leaf), kk <= 32; all contiguous.
extern "C" int leaf_topk_wgmma(const void* series, long long n_rows,
                               const void* leaf_start, const void* leaf_size,
                               const void* queries, const void* pair_order,
                               const void* bounds, const void* item_end,
                               const void* item_leaf, void* out_d,
                               void* out_i, int Q, int C, int L,
                               int m, int kk, long long out_rows,
                               void* stream) {
  namespace st = staged;
  if (Q <= 0 || C <= 0 || L <= 0) return cudaGetLastError();
  if (m <= 0 || m % 4 != 0 || kk < 1 || kk > st::MAX_KK || n_rows < 1 ||
      n_rows > INT_MAX - st::TN || !tf32x3::aligned16(series) ||
      !tf32x3::aligned16(queries))
    return cudaErrorInvalidValue;
  CUtensorMap map = {};
  cudaError_t err = st::tensor_map(&map, series, n_rows, m);
  if (err != cudaSuccess) return err;
  st::Args a;
  a.leaf_start = static_cast<const long long*>(leaf_start);
  a.leaf_size = static_cast<const long long*>(leaf_size);
  a.queries = static_cast<const float*>(queries);
  a.pair_order = static_cast<const long long*>(pair_order);
  a.bounds = static_cast<const long long*>(bounds);
  a.item_end = static_cast<const long long*>(item_end);
  a.item_leaf = static_cast<const long long*>(item_leaf);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<long long*>(out_i);
  a.out_rows = out_rows;
  a.C = C, a.L = L, a.m = m, a.kk = kk, a.nsr = st::ring_stages(kk);
  const int smem = st::smem_bytes(kk);
  // lists of kk entries in registers for kk <= 8, in shared memory beyond
  using Kernel = void (*)(const CUtensorMap, const st::Args);
#ifdef LEAF_TOPK_ONE_LIST
  const Kernel kernel = kk <= LEAF_TOPK_ONE_LIST
                            ? st::leaf_topk_wgmma_kernel<LEAF_TOPK_ONE_LIST>
                            : st::leaf_topk_wgmma_kernel<0>;
#else
  static const Kernel by_kk[st::REG_LIST + 1] = {
      st::leaf_topk_wgmma_kernel<0>, st::leaf_topk_wgmma_kernel<1>,
      st::leaf_topk_wgmma_kernel<2>, st::leaf_topk_wgmma_kernel<3>,
      st::leaf_topk_wgmma_kernel<4>, st::leaf_topk_wgmma_kernel<5>,
      st::leaf_topk_wgmma_kernel<6>, st::leaf_topk_wgmma_kernel<7>,
      st::leaf_topk_wgmma_kernel<8>};
  const Kernel kernel = by_kk[kk <= st::REG_LIST ? kk : 0];
#endif
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  kernel<<<hopper::sm_count(), st::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(map, a);
  return cudaGetLastError();
}

// the staged instance's dynamic shared memory a block and each pipeline's
// ring stages for kk: out[0] bytes, out[1] stages
extern "C" int leaf_topk_wgmma_smem(int kk, void* out) {
  static_cast<int*>(out)[0] = staged::smem_bytes(kk);
  static_cast<int*>(out)[1] = staged::ring_stages(kk);
  return 0;
}
