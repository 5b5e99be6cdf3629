// Filter training for Hopper (sm_90a): one SGD-with-momentum step of every
// filter MLP at once, as two kernels.
//
// Replaces no Pallas kernel: the reference's step is the jitted program
// _train_filters_jit (src/repro/core/filter_training.py:274; loss_fn :288,
// _sgd_step :267, the lax.scan over steps :340), which XLA fuses.  A step
// trains filter f on R = bg + bl rows: the bg global rows xg[ig] (shared by
// every filter) and its own bl local rows xl[f, il] (bl = bg / 4; R = 160 at
// the default batch of 128; the rows repeat, as the indices are drawn with
// replacement).
//
//   train_forward       pre = X.w1[f] + b1[f], pred = relu(pre).w2[f] + b2[f]
//                       dpred = (pred - y) * (1 - mask) * c   -> (F, R)
//                       with c = 2 w_g / (F bg) on global rows and
//                       2 (1 - w_g) / (F bl) on local rows (the reference's
//                       means); masked (validation) rows are computed and
//                       get 0.
//   train_backward_sgd  per filter (h in items of 128 lanes): pre
//                       recomputed, g_w2 = relu(pre)^T.dpred, g_b1 =
//                       sum dpred*w2*[pre>0], g_w1 = X^T.dpre with dpre =
//                       (dpred x w2) * [pre > 0]; then for w1, b1, w2 of
//                       those lanes (b2 in the first item's) v <-
//                       mu*v + g, p <- p - lr*v (_sgd_step's order, no
//                       fused multiply-add).  Parameters and
//                       velocities are updated in place; neither the
//                       gradients nor the hidden activations reach device
//                       memory.
//
// Bound on an H100 at a DSTree build (F = 4096, m = h = 256, R = 160): the
// products are 2*F*R*m*h = 85.9 GFLOP three times (forward, recompute,
// w1 gradient), 1.56 ms as three split-TF32 passes at 495 TFLOP/s (3.85 on
// the float32 CUDA cores); the bytes are w1 read by the forward kernel and
// w1 and its velocity each read and written by the update, 5 x 1.07 GB plus
// the gathered rows, 1.64 ms at 3.35 TB/s.  Recomputing pre costs a third
// of the products and no bytes (an item's w1, 256 KB, is read again by its
// own update, mostly from L2); the other way, a relu bit-mask written by the
// forward kernel (F*R*h bits, 21 MB here), would not give g_w2, which needs
// relu(pre) itself.
//
// Design (hopper.cuh has the layouts).  Both kernels are persistent:
// one block of three warpgroups per SM walks the items (forward: filter x
// 160-row tile; backward: filter x 128-lane group, two items a filter at
// h = 256) in a fixed stride.
// Warpgroup 0 produces: its warps (the backward kernel's warps 0-2) fill a
// ring of shared-memory stages (3 forward of 72 KB, 2 backward of 56 KB)
// with cp.async 16-byte copies of the gathered rows (raw and lo), placed at
// their 128-byte-swizzle addresses (TMA cannot gather rows), and each
// stage's w1 tile (32 rows of m x the item's lanes, 32-lane boxes) by TMA;
// a g_w1 stage carries 64 raw columns of the rows.  The backward kernel's
// warp 3 loads the update's w1 / v_w1 tiles by TMA into a 2-deep ring of
// their own and stores each updated tile by TMA.  Stages are handed over
// by mbarriers (full: each loader's cp.async arrival, which lands with its
// copies, and the TMA bytes; empty: one arrival per consumer warp; the
// update ring: warp 3's arrival with the TMA bytes, then the finalizing
// warps'), never by a block-wide barrier, and no loader waits for its own
// copies; setmaxnreg gives the producer 72 registers and each consumer 216
// (backward: 88 and 208), the split at which ptxas spills neither.
// Warpgroups 1 and 2 consume, each owning 80 of the 160 rows.
//
// * Layer 1, the same code in both kernels (so the backward kernel's pre
//   equals the forward kernel's bit for bit): pre^T (lanes x rows) = W1^T .
//   X^T by wgmma.mma_async m64n80k8 .tf32: A = W1^T from registers (each
//   thread reads its fragment of the stage's w1 tile and splits it, once a
//   fragment a warpgroup), B = the X rows as staged (K-major).  X's hi is
//   the raw row itself: the tensor cores read a float32 operand with its
//   13 low bits dropped (chip_smoke.py's rounding phase asserts it), so
//   x_hi = trunc(x).  Its lo = x - trunc(x) (exact) is made once a
//   training, the only copy of the rows added, so no kernel splits an X
//   element (the tensor cores drop lo's own 13 low bits in turn).  Three
//   products per k8 step, the small ones first: w1_lo.x_hi, w1_hi.x_lo,
//   w1_hi.x_hi, all of m into one accumulator (each step's sum rounded
//   toward zero).
// * The w1 gradient factors through the relu mask M (exact in TF32):
//   g_w1[k][l] = w2[l] * sum_r (x[r][k] * dpred[r]) * M[r][l].  Each thread
//   keeps its share of M as bits from the layer-1 accumulator and writes
//   one 64-lane chunk of it at a time into shared memory as M^T (K-major,
//   the B operand), and A = (X*dpred)^T is formed and split in
//   registers from the raw rows (a 64-column slice a stage, XOR-swizzled
//   for conflict-free fragment loads), once per chunk (so twice an item at
//   h = 256: holding the split across both chunks would cost 80 registers
//   a thread): two products per k8 step,
//   y_lo.M and y_hi.M, m64n64k8, each warpgroup over its own 80 rows in two
//   40-row stages, each stage summed on the tensor cores and the stages in
//   float32 to nearest; the two warpgroups' sums meet in the spent stage's
//   shared memory, rows 0-79 first.  (dpre itself is never split: M is
//   exact, and w2 multiplies the sum.)
// * The update: w1 and v_w1 of the 64 x 64 tile arrive by TMA with the
//   stage's raw rows; each element gets g = w2[l] * sum, v <- mu*v + g,
//   p <- p - lr*v in shared memory, and the tile leaves by TMA.
// So a backward item streams its filter's rows (raw and lo) once for
// layer 1 and the raw rows once more for g_w1, the slice serving both
// chunks: 6x the rows' bytes a filter at h = 256 (an item per chunk would
// stream 12x; the L2-to-SM traffic of the rows bounds this kernel).
// A larger batch (R > 160) takes 160-row tiles in turn: the forward kernel
// walks (filter, tile) items; the backward kernel is launched once per tile
// and each tile adds its gradients into the velocities (v <- mu*v + g on
// the first tile, v += g on each later one, p <- p - lr*v on the last).
// Ragged m and h are zero-filled or masked; shapes TMA cannot describe (h %
// 4 != 0 or an unaligned w1 / v_w1) stage w1 and the update tiles element
// by element, and m % 4 != 0 or unaligned rows stage X element by element,
// in the same layouts.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int ROWS = 160;               // rows a tile
constexpr int CONSUMERS = 2;            // consumer warpgroups
constexpr int WG_ROWS = ROWS / CONSUMERS;   // 80 rows each: layer 1's n80
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int F_LOADERS = 128;          // forward: the producer warpgroup
constexpr int B_LOADERS = 96;           // backward: its warps 0-2 (3: updates)
constexpr int TK = 32;                  // m columns a layer-1 stage
constexpr int F_STAGES = 3;            // the forward kernel's ring
constexpr int B_STAGES = 2;             // the backward kernel's
constexpr int MAX_STAGES = 3;
constexpr int XHALF = ROWS * TK * 4;    // one half of a stage's rows
constexpr int XSTAGE = 2 * XHALF;       // raw (hi) + lo, or 64 raw columns
constexpr int CHUNK = 64;               // backward: lanes an item
constexpr int MT = 64;                  // backward: m columns a g_w1 tile
constexpr int GK = 5;                   // k8 steps a g_w1 stage (40 rows)
constexpr int F_SLOT = XSTAGE + TK * 256 * 4;    // + w1, up to 256 lanes
constexpr int B_LANES = 128;            // backward: lanes an item
constexpr int B_SLOT = XSTAGE + TK * B_LANES * 4;
constexpr int MASK_BYTES = ROWS * CHUNK * 4;    // M^T of one chunk
constexpr int UPD_HALF = MT * CHUNK * 4;         // w1, then v_w1
constexpr int UPD_BUFS = 2;             // backward: the update tiles' ring
constexpr int RED_LD = 36;              // exchange stride (floats)
constexpr int BAR_CONS = 1;             // named barriers: both consumers,
constexpr int BAR_WG = 2;               // one consumer (+ its index),
constexpr int BAR_LOAD = 4;             // the loaders
constexpr uint32_t WBOX = TK * 32 * 4;  // a 32 x 32 w1 box
constexpr uint32_t UBOX = MT * 32 * 4;  // a 64 x 32 update box

struct Small {
  uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  uint64_t updfull[UPD_BUFS], updready[UPD_BUFS];
  const float* rraw[ROWS];              // the producer's row table: raw
  const float* rlo[ROWS];               // and lo rows
  union {
    float red[CONSUMERS][4][WG_ROWS];   // forward: layer-2 sums per warp
    struct {
      float red2[CONSUMERS][2][256];    // backward: g_w2, g_b1 per lane
      float w2s[256];                   // backward: the item's w2
    };
  };
  float dp[ROWS];
};

constexpr int F_SMEM = F_STAGES * F_SLOT + (int)sizeof(Small) + 1024;
constexpr int B_SMEM = B_STAGES * B_SLOT + MASK_BYTES + 2 * UPD_HALF * UPD_BUFS +
                       (int)sizeof(Small) + 1024;
static_assert(F_SMEM <= 232448 && B_SMEM <= 232448, "227 KB a block");

// what both kernels read of the step
struct Step {
  const float* xg;                      // (n_g, m) raw rows, read as hi
  const float* xl;                      // (F, n_l, m)
  const float* xg_lo;                   // (n_g, m): x - trunc(x)
  const float* xl_lo;                   // (F, n_l, m)
  const int64_t* ig;
  const int64_t* il;
  int F, m, h, n_g, n_l, bg, bl;
  int xvec, wvec;
};

template <int NS>
struct Ring {                           // a position in a ring of NS stages
  int it = 0;
  __device__ int slot() const { return it % NS; }
  __device__ uint32_t parity() const { return (it / NS) & 1; }
};

// w1 tile element (k, l): 32-lane boxes of TK (or MT) lines, swizzled
template <int LINES>
__device__ __forceinline__ uint32_t box_off(int k, int l) {
  return (l >> 5) * (LINES * 128u) + hopper::swz128(k, l & 31);
}

// the raw-row slice [ROWS][64]: chunk c of row r at c ^ 2(r % 4)
__device__ __forceinline__ uint32_t raw_off(int r, int c) {
  return r * 256u + ((((c >> 2) ^ ((r & 3) << 1))) << 4) + (c & 3) * 4u;
}

// the mask M^T [lane][row]: 32-row atoms of 64 lines
__device__ __forceinline__ uint32_t mask_off(int l, int r) {
  return (r >> 5) * (CHUNK * 128u) + hopper::swz128(l, r & 31);
}

// v <- mu*v + g, p <- p - lr*v, each product and sum rounded on its own;
// over row tiles the first tile's gradient makes v <- mu*v + g, each later
// one's is added to v, and the last tile applies p <- p - lr*v (one tile:
// _sgd_step, rounding for rounding)
__device__ __forceinline__ void sgd_tile(float* p, float* v, float grad,
                                         float lr, float mu, bool first,
                                         bool last) {
  const float nv = __fadd_rn(first ? __fmul_rn(mu, *v) : *v, grad);
  *v = nv;
  if (last) *p = __fsub_rn(*p, __fmul_rn(lr, nv));
}

// ---- the producer --------------------------------------------------------

// the row table of filter f's tile at step row r0 (loader ptid): global rows
// first, then the filter's local rows, nullptr (zero rows) past R
template <int NL>
__device__ __forceinline__ void gather(Small& s, const Step& a, int f, int r0,
                                       int ptid) {
  hopper::bar_sync(BAR_LOAD, NL);       // the last item's copies are issued
  for (int r = ptid; r < ROWS; r += NL) {
    const int rr = r0 + r;
    const float *raw = nullptr, *lo = nullptr;
    if (rr < a.bg) {
      const long long o = a.ig[rr] * (long long)a.m;
      raw = a.xg + o, lo = a.xg_lo + o;
    } else if (rr < a.bg + a.bl) {
      const long long o =
          ((long long)f * a.n_l + a.il[rr - a.bg]) * (long long)a.m;
      raw = a.xl + o, lo = a.xl_lo + o;
    }
    s.rraw[r] = raw, s.rlo[r] = lo;
  }
  hopper::bar_sync(BAR_LOAD, NL);
}

// columns [c0, c0 + TK) of the raw rows and their lo -> hi, lo (swizzled
// lines)
template <int NL>
__device__ __forceinline__ void load_x_split(char* dst, const Small& s,
                                             const Step& a, int c0,
                                             int ptid) {
  if (a.xvec) {
    for (int e = ptid; e < 2 * ROWS * 8; e += NL) {
      const int half = e >= ROWS * 8, q = e - half * ROWS * 8;
      const int r = q >> 3, ch = q & 7, col = c0 + ch * 4;
      const float* p = half ? s.rlo[r] : s.rraw[r];
      const bool ok = p != nullptr && col < a.m;
      tf32x3::cp_async16(dst + half * XHALF + hopper::swz128(r, ch * 4),
                         ok ? p + col : a.xg, ok);
    }
  } else {
    for (int e = ptid; e < 2 * ROWS * TK; e += NL) {
      const int half = e >= ROWS * TK, q = e - half * ROWS * TK;
      const int r = q / TK, c = q % TK, col = c0 + c;
      const float* p = half ? s.rlo[r] : s.rraw[r];
      *reinterpret_cast<float*>(dst + half * XHALF + hopper::swz128(r, c)) =
          p != nullptr && col < a.m ? p[col] : 0.f;
    }
  }
}

// columns [c0, c0 + MT) of the raw rows -> [ROWS][64] (raw_off)
__device__ __forceinline__ void load_x_raw(char* dst, const Small& s,
                                           const Step& a, int c0, int ptid) {
  if (a.xvec) {
    for (int e = ptid; e < ROWS * 16; e += B_LOADERS) {
      const int r = e >> 4, ch = e & 15, col = c0 + ch * 4;
      const float* p = s.rraw[r];
      const bool ok = p != nullptr && col < a.m;
      tf32x3::cp_async16(dst + raw_off(r, ch * 4), ok ? p + col : a.xg, ok);
    }
  } else {
    for (int e = ptid; e < ROWS * MT; e += B_LOADERS) {
      const int r = e / MT, c = e % MT, col = c0 + c;
      const float* p = s.rraw[r];
      *reinterpret_cast<float*>(dst + raw_off(r, c)) =
          p != nullptr && col < a.m ? p[col] : 0.f;
    }
  }
}

// rows [k0, k0 + TK) x lanes [l0, l0 + LANES) of filter f's w1 -> 32-lane
// boxes; TMA for the boxes that start below h (their bytes announced on
// `bar`), else element copies; returns the TMA bytes
template <int LANES, int NL>
__device__ __forceinline__ void load_w1(char* dst, const CUtensorMap* map,
                                        const float* w1, uint64_t* bar,
                                        const Step& a, int f, int k0, int l0,
                                        int ptid) {
  if (a.wvec) {
    if (ptid == 0) {
      uint32_t bytes = 0;
      for (int b = 0; b < LANES / 32; ++b)
        if (l0 + 32 * b < a.h) bytes += WBOX;
      hopper::mbar_arrive_tx(bar, bytes);
      for (int b = 0; b < LANES / 32; ++b)
        if (l0 + 32 * b < a.h)
          hopper::tma_load_3d(dst + b * WBOX, map, bar, l0 + 32 * b, k0, f);
    }
  } else {
    if (ptid == 0) hopper::mbar_arrive_tx(bar, 0);
    const float* W = w1 + (long long)f * a.m * a.h;
    for (int e = ptid; e < TK * LANES; e += NL) {
      const int k = e / LANES, l = e % LANES;
      const bool ok = k0 + k < a.m && l0 + l < a.h;
      *reinterpret_cast<float*>(dst + box_off<TK>(k, l)) =
          ok ? W[(long long)(k0 + k) * a.h + l0 + l] : 0.f;
    }
  }
}

// the loaders' end of a stage: each loader's arrival on the stage's full
// barrier lands once its copies have (element copies: at once, after the
// proxy fence); the loaders never wait for their own copies
template <int NS>
struct Loader {
  Ring<NS> ring;
  __device__ void begin(Small& s) {
    hopper::mbar_wait(&s.empty[ring.slot()], ring.parity() ^ 1);
  }
  __device__ void end(Small& s, bool async) {
    if (async) {
      hopper::cp_async_arrive(&s.full[ring.slot()]);
    } else {                            // element copies (and any cp.async)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&s.full[ring.slot()]);
    }
    ++ring.it;
  }
};

// ---- the consumers -------------------------------------------------------

__device__ __forceinline__ float ld_smem(const char* p, uint32_t off) {
  return *reinterpret_cast<const float*>(p + off);
}

// acc[i] (+)= W1^T[lanes i*64 ..] . X^T[the warpgroup's rows] over one TK
// stage: A fragments read from the stage's w1 tile and split (TG lane tiles
// x KG k8 steps at a time, which bounds the registers they take), B the
// staged hi / lo rows; three products per k8 step.  Each accumulator sees
// the same products in the same order whatever TG and KG are.  Warp w (of
// the warpgroup), lane 4g + t holds acc[i][4j + e] = pre^T[lane i*64 + 16w
// + g + 8(e / 2)][row 8j + 2t + e % 2] of its 80 rows.
template <int T, int TG, int KG>
__device__ __forceinline__ void layer1_stage(float (&acc)[T][40],
                                             const char* slot,
                                             const char* wt, int c, int wl,
                                             int g, int t, bool first) {
  static_assert(T % TG == 0 && (TK / 8) % KG == 0, "whole groups");
  const char* xhi = slot + c * (WG_ROWS * 128);
  const uint64_t dh0 = hopper::desc_sw128(xhi);
  const uint64_t dl0 = hopper::desc_sw128(xhi + XHALF);
  // the fragment's four elements of lane tile 0, k8 step 0: rows t, t + 4
  // of the tile, lanes 16w + g, + 8; later steps and tiles add whole lines
  // and boxes (k8 step: 8 lines; tile: two 32-lane boxes)
  const int l = 16 * wl + g;
  const char* w00 = wt + box_off<TK>(t, l);
  const char* w01 = wt + box_off<TK>(t, l + 8);
  const char* w10 = wt + box_off<TK>(t + 4, l);
  const char* w11 = wt + box_off<TK>(t + 4, l + 8);
#pragma unroll
  for (int k0 = 0; k0 < TK / 8; k0 += KG)
#pragma unroll
    for (int i0 = 0; i0 < T; i0 += TG) {
      uint32_t ah[KG][TG][4], al[KG][TG][4];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
#pragma unroll
        for (int i = 0; i < TG; ++i) {
          const int o = (k0 + kk) * 8 * 128 + (i0 + i) * 2 * (TK * 128);
          tf32x3::split(ld_smem(w00, o), ah[kk][i][0], al[kk][i][0]);
          tf32x3::split(ld_smem(w01, o), ah[kk][i][1], al[kk][i][1]);
          tf32x3::split(ld_smem(w10, o), ah[kk][i][2], al[kk][i][2]);
          tf32x3::split(ld_smem(w11, o), ah[kk][i][3], al[kk][i][3]);
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const uint64_t dh = hopper::desc_add(dh0, (k0 + kk) * 32);
        const uint64_t dl = hopper::desc_add(dl0, (k0 + kk) * 32);
        const int keep = !(first && k0 + kk == 0);
#pragma unroll
        for (int i = 0; i < TG; ++i) {
          hopper::wgmma_n80(acc[i0 + i], al[kk][i], dh, keep);
          hopper::wgmma_n80(acc[i0 + i], ah[kk][i], dl, 1);
          hopper::wgmma_n80(acc[i0 + i], ah[kk][i], dh, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < TG; ++i) hopper::fence_regs(acc[i0 + i]);
    }
}

// a consumer's wait for a stage; the proxy fence orders the loaders'
// cp.async writes, seen through the barrier, before the tensor cores read
template <int NS>
__device__ __forceinline__ void acquire(Small& s, const Ring<NS>& ring) {
  hopper::mbar_wait(&s.full[ring.slot()], ring.parity());
  hopper::fence_proxy_async();
}

// the consumer warp's release of a stage it has finished reading
template <int NS>
__device__ __forceinline__ void release(Small& s, Ring<NS>& ring, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(&s.empty[ring.slot()]);
  ++ring.it;
}

// ---- the kernels ---------------------------------------------------------

__device__ __forceinline__ char* aligned_smem(char* raw) {
  const uint32_t pad = (1024 - (hopper::smem_u32(raw) & 1023)) & 1023;
  return raw + pad;
}

// full: NL loaders + the TMA bytes' announcement; empty: the consumer
// warps; the backward kernel's update tiles: updfull, warp 3's lanes + its
// TMA bytes; updready, the 4 finalizing warps
template <int NL, int NS>
__device__ __forceinline__ void init_barriers(Small& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      hopper::mbar_init(&s.full[i], NL + 1);
      hopper::mbar_init(&s.empty[i], 4 * CONSUMERS);
    }
    for (int i = 0; i < UPD_BUFS; ++i) {
      hopper::mbar_init(&s.updfull[i], 33);
      hopper::mbar_init(&s.updready[i], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// T m64 lane tiles a warpgroup (T * 64 lanes a pass over m)
template <int T>
__global__ void __launch_bounds__(THREADS, 1)
train_forward_kernel(__grid_constant__ const CUtensorMap map_w1,
                     const Step a, const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ ygz,
                     const float* __restrict__ ylz,
                     const float* __restrict__ vg,
                     const float* __restrict__ vl, float* __restrict__ dpred,
                     float cg, float cl) {
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  Small& s = *reinterpret_cast<Small*>(smem + F_STAGES * F_SLOT);
  init_barriers<F_LOADERS, F_STAGES>(s);
  const int R = a.bg + a.bl;
  const int tiles = (R + ROWS - 1) / ROWS;
  const int items = a.F * tiles;
  const int stages = (a.m + TK - 1) / TK;
  constexpr int LANES = T * 64;
  const int groups = (a.h + LANES - 1) / LANES;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {                        // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int ptid = threadIdx.x;
    Loader<F_STAGES> ld;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int f = item / tiles, r0 = (item % tiles) * ROWS;
      gather<F_LOADERS>(s, a, f, r0, ptid);
      for (int lg = 0; lg < groups; ++lg)
        for (int st = 0; st < stages; ++st) {
          ld.begin(s);
          char* slot = smem + ld.ring.slot() * F_SLOT;
          load_w1<LANES, F_LOADERS>(slot + XSTAGE, &map_w1, w1,
                                    &s.full[ld.ring.slot()], a, f, st * TK,
                                    lg * LANES, ptid);
          load_x_split<F_LOADERS>(slot, s, a, st * TK, ptid);
          ld.end(s, a.xvec && a.wvec);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int c = wg - 1, ct = threadIdx.x - 128 * wg;
  const int wl = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
  Ring<F_STAGES> ring;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int f = item / tiles, r0 = (item % tiles) * ROWS;
    const long long fh = (long long)f * a.h;
    for (int lg = 0; lg < groups; ++lg) {
      float acc[T][40];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int q = 0; q < 40; ++q) acc[i][q] = 0.f;
      for (int st = 0; st < stages; ++st) {
        acquire(s, ring);
        const char* slot = smem + ring.slot() * F_SLOT;
        layer1_stage<T, 2, 1>(acc, slot, slot + XSTAGE, c, wl, g, t, st == 0);
        release(s, ring, lane);
      }
      // layer 2 over the pass's lanes: rows 8j + 2t + e in z[2j + e]
      float z[20];
#pragma unroll
      for (int q = 0; q < 20; ++q) z[q] = 0.f;
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = lg * LANES + i * 64 + 16 * wl + g + 8 * hh;
          if (l >= a.h) continue;
          const float bj = b1[fh + l], wj = w2[fh + l];
#pragma unroll
          for (int j = 0; j < 10; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              z[2 * j + e] = fmaf(fmaxf(acc[i][4 * j + 2 * hh + e] + bj, 0.f),
                                  wj, z[2 * j + e]);
        }
      // the 8 lane groups g of a warp hold the same rows; each pass's sums
      // add into the warp's row of red (its own entries: no sync)
#pragma unroll
      for (int q = 0; q < 20; ++q) {
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 4);
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 8);
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 16);
      }
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 10; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& o = s.red[c][wl][8 * j + 2 * t + e];
            o = lg == 0 ? z[2 * j + e] : o + z[2 * j + e];
          }
    }
    hopper::bar_sync(BAR_WG + c, 128);
    const int r = r0 + c * WG_ROWS + ct;
    if (ct < WG_ROWS && r < R) {
      float pred = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) pred += s.red[c][w][ct];
      pred += b2[f];
      float y, mask, coef;
      if (r < a.bg) {
        const long long i = a.ig[r];
        y = ygz[(long long)f * a.n_g + i];
        mask = vg[i];
        coef = cg;
      } else {
        const long long i = a.il[r - a.bg];
        y = ylz[(long long)f * a.n_l + i];
        mask = vl[i];
        coef = cl;
      }
      dpred[(long long)f * R + r] = (pred - y) * (1.f - mask) * coef;
    }
    hopper::bar_sync(BAR_WG + c, 128);  // red is read before it is rewritten
  }
}

// The update tile of a raw-row stage: w1 then v_w1, 64 rows of m x 64
// lanes, in 32-lane boxes at the slot's XSTAGE; TMA, or element copies
// (ptid < NL) when TMA cannot describe w1
template <int NL>
__device__ __forceinline__ void load_update(char* dst, const CUtensorMap* mw,
                                            const CUtensorMap* mv,
                                            const float* w1, const float* vw1,
                                            uint64_t* bar, const Step& a,
                                            int f, int k0, int l0, int ptid) {
  if (a.wvec) {
    if (ptid == 0) {
      uint32_t bytes = 0;
      for (int b = 0; b < 2; ++b)
        if (l0 + 32 * b < a.h) bytes += 2 * UBOX;
      hopper::mbar_arrive_tx(bar, bytes);
      for (int b = 0; b < 2; ++b)
        if (l0 + 32 * b < a.h) {
          hopper::tma_load_3d(dst + b * UBOX, mw, bar, l0 + 32 * b, k0, f);
          hopper::tma_load_3d(dst + UPD_HALF + b * UBOX, mv, bar, l0 + 32 * b,
                              k0, f);
        }
    }
  } else {
    if (ptid == 0) hopper::mbar_arrive_tx(bar, 0);
    const long long o = (long long)f * a.m * a.h;
    for (int e = ptid; e < MT * CHUNK; e += NL) {
      const int k = e / CHUNK, l = e % CHUNK;
      const bool ok = k0 + k < a.m && l0 + l < a.h;
      const long long i = o + (long long)(k0 + k) * a.h + l0 + l;
      *reinterpret_cast<float*>(dst + box_off<MT>(k, l)) = ok ? w1[i] : 0.f;
      *reinterpret_cast<float*>(dst + UPD_HALF + box_off<MT>(k, l)) =
          ok ? vw1[i] : 0.f;
    }
  }
}

// One row tile of the step, rows [r0, r0 + ROWS): first / last say which
// of a larger batch's tiles it is (both for one tile).  An item is a
// filter's 128 lanes: layer 1 over them as the forward kernel takes it
// (two m64 lane tiles a warpgroup), then g_w1 over MT-column tiles of m,
// each tile's raw rows staged once for both of the item's 64-lane chunks.
__global__ void __launch_bounds__(THREADS, 1)
train_backward_sgd_kernel(__grid_constant__ const CUtensorMap map_w1,
                          __grid_constant__ const CUtensorMap map_w1u,
                          __grid_constant__ const CUtensorMap map_v1u,
                          const Step a, float* __restrict__ w1,
                          float* __restrict__ b1, float* __restrict__ w2,
                          float* __restrict__ b2, float* __restrict__ vw1,
                          float* __restrict__ vb1, float* __restrict__ vw2,
                          float* __restrict__ vb2,
                          const float* __restrict__ dpred, float lr, float mu,
                          int r0, int first, int last) {
  constexpr int T = B_LANES / 64;
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* mask = smem + B_STAGES * B_SLOT;    // M^T of the current chunk
  char* upds = mask + MASK_BYTES;           // the update tiles' ring
  Small& s = *reinterpret_cast<Small*>(upds + 2 * UPD_HALF * UPD_BUFS);
  init_barriers<B_LOADERS, B_STAGES>(s);
  const int R = a.bg + a.bl;
  const int groups = (a.h + B_LANES - 1) / B_LANES;
  const int items = a.F * groups;
  const int stages = (a.m + TK - 1) / TK;
  const int mtiles = (a.m + MT - 1) / MT;
  const int wg = threadIdx.x / 128;
  // the item's 64-lane chunks that start below h
  auto nchunks = [&](int lg) { return a.h - lg * B_LANES > CHUNK ? 2 : 1; };

  if (wg == 0) {                        // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    const int ptid = threadIdx.x;
    if (ptid < B_LOADERS) {             // warps 0-2: the stage ring
      Loader<B_STAGES> ld;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int f = item / groups, lg = item % groups;
        gather<B_LOADERS>(s, a, f, r0, ptid);
        for (int st = 0; st < stages; ++st) {
          ld.begin(s);
          char* slot = smem + ld.ring.slot() * B_SLOT;
          load_w1<B_LANES, B_LOADERS>(slot + XSTAGE, &map_w1, w1,
                                      &s.full[ld.ring.slot()], a, f, st * TK,
                                      lg * B_LANES, ptid);
          load_x_split<B_LOADERS>(slot, s, a, st * TK, ptid);
          ld.end(s, a.xvec && a.wvec);
        }
        for (int p = 0; p < mtiles; ++p) {
          ld.begin(s);
          if (ptid == 0) hopper::mbar_arrive_tx(&s.full[ld.ring.slot()], 0);
          load_x_raw(smem + ld.ring.slot() * B_SLOT, s, a, p * MT, ptid);
          ld.end(s, a.xvec);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }
    // warp 3: the update tiles, (m tile, chunk) in the consumers' order,
    // through a ring of UPD_BUFS: a tile is stored once its finalizing
    // warps are done with it, and the tile UPD_BUFS later loads in its
    // place
    const int lane = ptid - B_LOADERS;
    static_assert(UPD_BUFS == 2, "two buffers' tiles in registers");
    int u = 0;
    int f0 = 0, k00 = 0, l00 = 0, f1 = 0, k01 = 0, l01 = 0;  // their tiles
    auto store = [&](int b) {
      hopper::mbar_wait(&s.updready[b], ((u - UPD_BUFS) / UPD_BUFS) & 1);
      const int f = b ? f1 : f0, k0 = b ? k01 : k00, l0 = b ? l01 : l00;
      const char* upd = upds + b * 2 * UPD_HALF;
      if (a.wvec) {
        if (lane == 0) {
          for (int bx = 0; bx < 2; ++bx)
            if (l0 + 32 * bx < a.h) {
              hopper::tma_store_3d(&map_w1u, upd + bx * UBOX, l0 + 32 * bx,
                                   k0, f);
              hopper::tma_store_3d(&map_v1u, upd + UPD_HALF + bx * UBOX,
                                   l0 + 32 * bx, k0, f);
            }
          hopper::bulk_commit();
          hopper::bulk_wait_read();
        }
      } else {
        const long long o = (long long)f * a.m * a.h;
        for (int e = lane; e < MT * CHUNK; e += 32) {
          const int k = e / CHUNK, l = e % CHUNK;
          if (k0 + k < a.m && l0 + l < a.h) {
            const long long i = o + (long long)(k0 + k) * a.h + l0 + l;
            w1[i] = ld_smem(upd, box_off<MT>(k, l));
            vw1[i] = ld_smem(upd + UPD_HALF, box_off<MT>(k, l));
          }
        }
      }
      __syncwarp();
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int f = item / groups, lg = item % groups;
      for (int p = 0; p < mtiles; ++p)
        for (int q = 0; q < nchunks(lg); ++q) {
          const int b = u % UPD_BUFS;
          if (u >= UPD_BUFS) store(b);
          load_update<32>(upds + b * 2 * UPD_HALF, &map_w1u, &map_v1u, w1,
                          vw1, &s.updfull[b], a, f, p * MT,
                          lg * B_LANES + q * CHUNK, lane);
          __syncwarp();
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&s.updfull[b]);
          const int l0 = lg * B_LANES + q * CHUNK;
          if (b)
            f1 = f, k01 = p * MT, l01 = l0;
          else
            f0 = f, k00 = p * MT, l00 = l0;
          ++u;
        }
    }
    const int loaded = u;
    for (int uu = loaded - UPD_BUFS; uu < loaded; ++uu) {
      if (uu < 0) continue;             // the last tiles, oldest first
      u = uu + UPD_BUFS;
      store(uu % UPD_BUFS);
    }
    if (a.wvec && lane == 0) hopper::bulk_wait();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  const int c = wg - 1, ct = threadIdx.x - 128;   // ct: 0..255
  const int wl = (ct % 128) / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
  const bool finalizer = (c == 0) == (wl < 2);
  Ring<B_STAGES> ring;
  int u = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int f = item / groups, lg = item % groups, nq = nchunks(lg);
    const long long fh = (long long)f * a.h;

    // layer 1 over the item's lanes x this warpgroup's 80 rows
    float acc[T][40];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int e = 0; e < 40; ++e) acc[i][e] = 0.f;
    for (int st = 0; st < stages; ++st) {
      acquire(s, ring);
      const char* slot = smem + ring.slot() * B_SLOT;
      layer1_stage<T, 2, 2>(acc, slot, slot + XSTAGE, c, wl, g, t, st == 0);
      release(s, ring, lane);
    }

    hopper::bar_sync(BAR_CONS, 256);    // the last item is done with dp, w2s
    if (ct < ROWS) {
      const int r = r0 + ct;
      s.dp[ct] = r < R ? dpred[(long long)f * R + r] : 0.f;
    }
    if (ct < B_LANES) {
      const int lg2 = lg * B_LANES + ct;
      s.w2s[ct] = lg2 < a.h ? w2[fh + lg2] : 0.f;
    }
    hopper::bar_sync(BAR_CONS, 256);

    // the relu mask, kept as bits (tile i: bit 20hh + 2j + e), and the
    // g_w2, g_b1 sums of this warpgroup's rows
    uint64_t mbits[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      mbits[i] = 0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int l = i * 64 + 16 * wl + g + 8 * hh, lg2 = lg * B_LANES + l;
        const bool valid = lg2 < a.h;
        const float bj = valid ? b1[fh + lg2] : 0.f, wj = s.w2s[l];
        float gw2 = 0.f, gb1 = 0.f;
#pragma unroll
        for (int j = 0; j < 10; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre = acc[i][4 * j + 2 * hh + e] + bj;
            const float d = s.dp[c * WG_ROWS + 8 * j + 2 * t + e];
            const bool on = valid && pre > 0.f;
            if (valid) gw2 = fmaf(fmaxf(pre, 0.f), d, gw2);
            gb1 += on ? d * wj : 0.f;
            mbits[i] |= (uint64_t)on << (20 * hh + 2 * j + e);
          }
        gw2 += __shfl_xor_sync(0xffffffffu, gw2, 1);
        gw2 += __shfl_xor_sync(0xffffffffu, gw2, 2);
        gb1 += __shfl_xor_sync(0xffffffffu, gb1, 1);
        gb1 += __shfl_xor_sync(0xffffffffu, gb1, 2);
        if (t == 0) s.red2[c][0][l] = gw2, s.red2[c][1][l] = gb1;
      }
    }
    hopper::bar_sync(BAR_CONS, 256);
    if (ct < B_LANES && lg * B_LANES + ct < a.h) {
      const long long i = fh + lg * B_LANES + ct;
      sgd_tile(w2 + i, vw2 + i, s.red2[0][0][ct] + s.red2[1][0][ct], lr, mu,
               first, last);
      sgd_tile(b1 + i, vb1 + i, s.red2[0][1][ct] + s.red2[1][1][ct], lr, mu,
               first, last);
    }
    if (lg == 0 && ct >= 224) {         // b2: the first lane group's item
      float sum = 0.f;
      for (int r = lane; r < ROWS; r += 32) sum += s.dp[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) sgd_tile(b2 + f, vb2 + f, sum, lr, mu, first, last);
    }

    // g_w1, MT columns of m a tile, each tile's raw rows for both chunks:
    // rows [80c, 80c + 80) in two stages
    for (int p = 0; p < mtiles; ++p) {
      acquire(s, ring);
      const char* xr = smem + ring.slot() * B_SLOT;
#pragma unroll 1
      for (int q = 0; q < nq; ++q) {
        static_assert(T == 2, "the chunk's bits: one of two words");
        const uint64_t bits = q ? mbits[1] : mbits[0];
        // oz = 0: the tile's row-dependent addresses are formed here, not
        // held in registers across the loop
        const int oz = hopper::opaque_zero();
        hopper::bar_sync(BAR_CONS, 256);  // M^T (and the exchange) is free
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 10; ++j) {
            const int bit = 20 * hh + 2 * j;
            *reinterpret_cast<float2*>(
                mask + mask_off(16 * wl + g + 8 * hh,
                                c * WG_ROWS + 8 * j + 2 * t + oz)) =
                make_float2((bits >> bit) & 1 ? 1.f : 0.f,
                            (bits >> (bit + 1)) & 1 ? 1.f : 0.f);
          }
        hopper::fence_proxy_async();    // M^T is read by the tensor cores
        hopper::bar_sync(BAR_CONS, 256);
        float tot[32];
        // A's elements: rows 80c + 8K + t (+ 4) x columns 16w + g (+ 8);
        // a row's XOR depends on row % 4 = t alone, so a k8 step adds 8 rows
        const char* xa = xr + c * (WG_ROWS * 256) + raw_off(t, 16 * wl + g);
        const char* xb8 = xr + c * (WG_ROWS * 256) + raw_off(t, 16 * wl + g + 8);
        const float* dpc = s.dp + c * WG_ROWS + t;
        const uint64_t dm0 = hopper::desc_sw128(mask);
#pragma unroll
        for (int sg = 0; sg < 2; ++sg) {
          const int kz = c * 10 + sg * GK + oz;  // first k8 step (rows / 8)
          uint32_t ah[GK][4], al[GK][4];
#pragma unroll
          for (int kk = 0; kk < GK; ++kk) {
            const int o = (sg * GK + kk) * 8;   // the step's first row
            const float da = dpc[o], db = dpc[o + 4];
            tf32x3::split(__fmul_rn(ld_smem(xa, o * 256), da), ah[kk][0],
                          al[kk][0]);
            tf32x3::split(__fmul_rn(ld_smem(xb8, o * 256), da), ah[kk][1],
                          al[kk][1]);
            tf32x3::split(__fmul_rn(ld_smem(xa, (o + 4) * 256), db),
                          ah[kk][2], al[kk][2]);
            tf32x3::split(__fmul_rn(ld_smem(xb8, (o + 4) * 256), db),
                          ah[kk][3], al[kk][3]);
          }
          float acc2[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) acc2[e] = 0.f;
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < GK; ++kk) {
            const int K = kz + kk;
            const uint64_t dm =
                hopper::desc_add(dm0, (K >> 2) * (CHUNK * 128) + (K & 3) * 32);
            hopper::wgmma_n64(acc2, al[kk], dm, kk > 0);
            hopper::wgmma_n64(acc2, ah[kk], dm, 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc2);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            tot[e] = sg == 0 ? acc2[e] : tot[e] + acc2[e];
        }
        // rows 0-79 plus rows 80-159: the finalizing warps (warps 0-1 of
        // the first warpgroup, 2-3 of the second) take the other's half of
        // the tile through M^T's shared memory, spent
        hopper::bar_sync(BAR_CONS, 256);
        float* xb = reinterpret_cast<float*>(mask) + (wl * 32 + lane) * RED_LD;
        if (!finalizer)
#pragma unroll
          for (int e = 0; e < 32; e += 4)
            *reinterpret_cast<float4*>(xb + e) =
                make_float4(tot[e], tot[e + 1], tot[e + 2], tot[e + 3]);
        hopper::bar_sync(BAR_CONS, 256);
        if (finalizer) {
#pragma unroll
          for (int e = 0; e < 32; e += 4) {
            const float4 o = *reinterpret_cast<const float4*>(xb + e);
            tot[e] += o.x, tot[e + 1] += o.y, tot[e + 2] += o.z,
                tot[e + 3] += o.w;
          }
          const int b = u % UPD_BUFS;
          char* upd = upds + b * 2 * UPD_HALF;
          hopper::mbar_wait(&s.updfull[b], (u / UPD_BUFS) & 1);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int k = 16 * wl + g + 8 * hh + oz, l = 8 * j + 2 * t;
              const uint32_t off = box_off<MT>(k, l);
              float2 w = *reinterpret_cast<const float2*>(upd + off);
              float2 v = *reinterpret_cast<const float2*>(upd + UPD_HALF + off);
              sgd_tile(&w.x, &v.x,
                       __fmul_rn(s.w2s[q * CHUNK + l], tot[4 * j + 2 * hh]),
                       lr, mu, first, last);
              sgd_tile(&w.y, &v.y,
                       __fmul_rn(s.w2s[q * CHUNK + l + 1],
                                 tot[4 * j + 2 * hh + 1]),
                       lr, mu, first, last);
              *reinterpret_cast<float2*>(upd + off) = w;
              *reinterpret_cast<float2*>(upd + UPD_HALF + off) = v;
            }
          hopper::fence_proxy_async();  // the tile leaves by TMA
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&s.updready[b]);
        }
        ++u;
      }
      release(s, ring, lane);
    }
  }
}

// ---- host side -----------------------------------------------------------

// the 3D view (h, m, F) of a (F, m, h) float32 tensor in boxes of 32 lanes
// x `rows` rows of m, 128-byte swizzle, zeros outside
cudaError_t tensor_map(CUtensorMap* map, const void* base, int F, int m,
                       int h, int rows) {
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)h, (cuuint64_t)m, (cuuint64_t)F};
  const cuuint64_t strides[2] = {(cuuint64_t)h * 4, (cuuint64_t)m * h * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

Step make_step(const void* xg, const void* xl, const void* xg_lo,
               const void* xl_lo, const void* ig, const void* il, int F,
               int m, int h, int n_g, int n_l, int bg, int bl, int wvec) {
  Step a;
  a.xg = static_cast<const float*>(xg), a.xl = static_cast<const float*>(xl);
  a.xg_lo = static_cast<const float*>(xg_lo);
  a.xl_lo = static_cast<const float*>(xl_lo);
  a.ig = static_cast<const int64_t*>(ig), a.il = static_cast<const int64_t*>(il);
  a.F = F, a.m = m, a.h = h, a.n_g = n_g, a.n_l = n_l, a.bg = bg, a.bl = bl;
  a.xvec = m % 4 == 0 && tf32x3::aligned16(xg) && tf32x3::aligned16(xl) &&
           tf32x3::aligned16(xg_lo) && tf32x3::aligned16(xl_lo);
  a.wvec = wvec;
  return a;
}

}  // namespace

// w1 (F, m, h), b1 and w2 (F, h), b2 (F,); xg (n_g, m), xl (F, n_l, m) and
// their lo parts xg_lo, xl_lo of the same shapes (x - x with its 13 low
// bits dropped); ig (bg,) and il (bl,) int64 row indices; ygz
// (F, n_g), ylz (F, n_l); vg (n_g,), vl (n_l,) -> dpred (F, bg + bl); all
// contiguous, float32 but the indices.
extern "C" int train_forward(const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* xg, const void* xl,
                             const void* ig, const void* il, const void* ygz,
                             const void* ylz, const void* vg, const void* vl,
                             void* dpred, const void* xg_lo,
                             const void* xl_lo, int F, int m, int h, int n_g,
                             int n_l, int bg, int bl, float cg, float cl,
                             void* stream) {
  if (bg < 1 || bl < 1) return cudaErrorInvalidValue;
  if (F <= 0 || h <= 0 || m <= 0) return cudaGetLastError();
  const int wvec = h % 4 == 0 && tf32x3::aligned16(w1);
  const Step a = make_step(xg, xl, xg_lo, xl_lo, ig, il, F, m, h, n_g, n_l,
                           bg, bl, wvec);
  CUtensorMap map = {};
  cudaError_t err =
      wvec ? tensor_map(&map, w1, F, m, h, TK) : cudaSuccess;
  if (err != cudaSuccess) return err;
  const long long items = (long long)F * ((bg + bl + ROWS - 1) / ROWS);
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int sms = hopper::sm_count();
  const int blocks = (int)(items < sms ? items : sms);
  auto kernel = h > 128 ? train_forward_kernel<4> : train_forward_kernel<2>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map, a, static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ygz), static_cast<const float*>(ylz),
      static_cast<const float*>(vg), static_cast<const float*>(vl),
      static_cast<float*>(dpred), cg, cl);
  return cudaGetLastError();
}

// the parameters (as train_forward) and their velocities, updated in place;
// xg, xl, their lo parts, ig, il as train_forward; dpred (F, bg + bl) from
// it.
extern "C" int train_backward_sgd(void* w1, void* b1, void* w2, void* b2,
                                  void* vw1, void* vb1, void* vw2, void* vb2,
                                  const void* xg, const void* xl,
                                  const void* ig, const void* il,
                                  const void* dpred, const void* xg_lo,
                                  const void* xl_lo, int F, int m, int h,
                                  int n_l, int n_g, int bg, int bl, float lr,
                                  float mu, void* stream) {
  if (bg < 1 || bl < 1) return cudaErrorInvalidValue;
  if (F <= 0 || h <= 0 || m <= 0) return cudaGetLastError();
  const long long items = (long long)F * ((h + B_LANES - 1) / B_LANES);
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int wvec = h % 4 == 0 && tf32x3::aligned16(w1) &&
                   tf32x3::aligned16(vw1);
  const Step a = make_step(xg, xl, xg_lo, xl_lo, ig, il, F, m, h, n_g, n_l,
                           bg, bl, wvec);
  CUtensorMap map_w1 = {}, map_w1u = {}, map_v1u = {};
  if (wvec) {
    cudaError_t err = tensor_map(&map_w1, w1, F, m, h, TK);
    if (err == cudaSuccess) err = tensor_map(&map_w1u, w1, F, m, h, MT);
    if (err == cudaSuccess) err = tensor_map(&map_v1u, vw1, F, m, h, MT);
    if (err != cudaSuccess) return err;
  }
  const int sms = hopper::sm_count();
  const int blocks = (int)(items < sms ? items : sms);
  cudaError_t err = cudaFuncSetAttribute(
      train_backward_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      B_SMEM);
  if (err != cudaSuccess) return err;
  // one launch a row tile, in stream order: each tile reads the parameters
  // the last one alone updates
  const int R = bg + bl;
  for (int r0 = 0; r0 < R; r0 += ROWS) {
    train_backward_sgd_kernel<<<blocks, THREADS, B_SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
        map_w1, map_w1u, map_v1u, a, static_cast<float*>(w1),
        static_cast<float*>(b1), static_cast<float*>(w2),
        static_cast<float*>(b2), static_cast<float*>(vw1),
        static_cast<float*>(vb1), static_cast<float*>(vw2),
        static_cast<float*>(vb2), static_cast<const float*>(dpred), lr, mu,
        r0, r0 == 0, r0 + ROWS >= R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// each kernel's dynamic shared memory a block: out[0] forward, out[1]
// backward (bytes)
extern "C" int train_smem(void* out) {
  static_cast<int*>(out)[0] = F_SMEM;
  static_cast<int*>(out)[1] = B_SMEM;
  return 0;
}
