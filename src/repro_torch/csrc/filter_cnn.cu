// The 2-layer CNN filter backbone for Hopper (sm_90a): every filter's
// de-standardized prediction for every query, (F, Q), in one launch.
//
// Replaces no Pallas kernel: the reference computes the CNN filters of its
// Table 1 / Fig. 12 ablation in XLA (src/repro/core/filters.py:176
// apply_cnn, two conv_general_dilated calls under a vmap over filters).
// For filter f and query x (m values):
//   h1[p, c] = relu(sum_k x[p + k - pl] * c1[f, k, 0, c])          (m, C)
//   h2[p, o] = relu(sum_k sum_i h1[p + k - pl, i] * c2[f, k, i, o]) (m, C)
//   z        = (1/m) sum_p sum_o h2[p, o] * w[f, o] + b[f]
//   out[f,q] = z * y_std[f] + y_mean[f]
// with "SAME" zero padding as XLA takes it at stride 1: pl = (K - 1) / 2
// positions before, K / 2 after (x and h1 are zero outside [0, m)).
//
// Bound on an H100: conv 2 is m * C * K * C multiply-adds a (filter, query)
// pair, ~101 MFLOP at m = C = 256, K = 3; at F = 4096 and the 180
// calibration queries 7.46e13 FLOP: ~1.11 s at the 67 TFLOP/s float32
// CUDA-core peak, ~0.45 s as three TF32 passes at 495 TFLOP/s (the design
// below), while the inputs are 3.2 GB of c2 (~1 ms at 3.35 TB/s):
// operations bound it.  The intermediates cannot go to memory: conv 2's
// output at calibration is F * Q * m * C floats, 193 GB.
//
// Design: conv 2 on split-TF32 wgmma (float32 accuracy on the tensor
// cores: one TF32 pass errs ~10x past the hold's limit), warp-specialized.
//   * A block per (filter, query tile): its queries' rows side by side,
//     each query followed by K - 1 zero rows (its "SAME" padding), fill
//     the 256 columns of D = c2^T . h1^T (wgmma m64n256k8; at m = 256 one
//     query); m > 256 takes ceil(m / 256) column tiles a query.  Three
//     warpgroups: a producer and two consumers, 64 output channels each (a
//     pass: 128); two rings of shared-memory stages handed over by
//     mbarriers.
//   * Operand roles.  A is c2, read into registers from a [32 input
//     channels][128 output channels] tile staged by cp.async as c2 stores
//     it (output channels contiguous) and split there (hi = rna(x), lo =
//     trunc(x - hi)); c2 needs no copy (as B it would be MN-major, which
//     TF32 wgmma refuses).  B is conv 1's output over a chunk of 32 input
//     channels, which the producer writes once a chunk, raw and lo = x -
//     trunc(x) (the tensor cores read x with its 13 low bits dropped, so
//     b_hi = trunc(x)), K-major without swizzle: 8 lines of 16 bytes make a
//     128-byte core matrix, so one tile of 256 + 32 lines serves every
//     shift k < 33, its descriptor starting k lines (16k bytes) further on
//     (a one-line shift would break a swizzle atom).  Three products a k8
//     step, the small ones first: a_lo.b_hi, a_hi.b_lo, a_hi.b_hi, all of
//     K x C into one accumulator (each step's sum rounded toward zero).
//   * Conv 1 is computed once per (row, channel) a pass, for all K shifts,
//     from the block's query rows staged in shared memory with their zeros
//     and the chunk's c1 taps (global loads where they do not fit, or K >
//     33: the tile then serves 33 shifts at a time).  The c2 ring runs
//     ahead by shifts, the B ring by chunks.
//   * A pass covers 128 output channels, so the block reads each c2
//     element from L2 once for all its rows; C > 128 takes ceil(C / 128)
//     passes, each recomputing conv 1 (K FMAs an element against conv 2's
//     K * C).  The register file bounds a pass: 256 columns x 128 channels
//     is 128 accumulators a consumer thread.
//   * Epilogue in a fixed order, no float atomics (a call repeats
//     bitwise): relu(h2) * w over each thread's two channels, the eight
//     lane groups of a warp by a fixed shuffle tree, the warps and then
//     the passes in order into a column total, and each query adds its
//     columns in increasing position; then / m, + b, de-standardized.
// Every K >= 1, C >= 1, m >= 1, F and Q are served: a ragged channel
// chunk or pass and padding columns are zero-filled, a warpgroup whose
// channels lie past C skips its products, and c2 is staged by 16-byte
// cp.async where C % 4 == 0 and c2 is 16-byte aligned (element copies
// otherwise).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int ROWS = 256;               // D's columns a tile: wgmma's n
constexpr int OW = 128;                 // output channels a pass
constexpr int TK = 32;                  // input channels a chunk
constexpr int KT = 33;                  // shifts a B tile serves
constexpr int LT = ROWS + KT - 1;       // a B tile's lines
constexpr int BSTAGES = 2;              // B tiles, a chunk each
constexpr int CSTAGES = 3;              // c2 tiles, a (chunk, shift) each
constexpr int CONSUMERS = 2;            // consumer warpgroups, 64 channels each
constexpr int LOADERS = 128;            // the producer warpgroup
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int LDA = OW + 8;             // the c2 tile's row stride (floats):
                                        // conflict-free fragment loads
constexpr int BTILE = LT * TK * 4;      // a B tile, raw or lo (bytes)
constexpr int ATILE = TK * LDA * 4;     // a c2 tile (bytes)
constexpr int XS_MAX = 3584;            // the block's padded query rows
constexpr int BAR_LOAD = 1;             // named barriers: the producer's,
constexpr int BAR_CONS = 2;             // the consumers'
constexpr int PRODUCER_REGS = 136;      // setmaxnreg (128 x 136 + 256 x
constexpr int CONSUMER_REGS = 184;      // 184 = 384 x 168, the launch's)

struct Args {
  const float* q;       // (Q, m)
  const float* c1;      // (F, K, 1, C)
  const float* c2;      // (F, K, C, C)
  const float* w;       // (F, C)
  const float* b;       // (F,)
  const float* y_mean;  // (F,)
  const float* y_std;   // (F,)
  float* out;           // (F, Q)
  int Q, m, K, C;
  int qt;               // queries a block
  int tiles;            // query tiles a filter
  int span;             // a query's columns: m + K - 1 (m <= ROWS)
  int vec;              // c2 staged by 16-byte cp.async
};

struct Small {
  uint64_t bfull[BSTAGES], bempty[BSTAGES];
  uint64_t cfull[CSTAGES], cempty[CSTAGES];
  float red[CONSUMERS][4][ROWS];        // a warp's column sums
  float rowsum[ROWS];
  float zacc[ROWS];                     // a query's sum (qt <= 256)
  float xs[XS_MAX];                     // [query][pl zeros, x, K/2 zeros]
  float c1s[KT][TK];                    // the chunk's c1 taps
  int loff[LT];                         // a line's first tap in xs, -1: 0
};

constexpr size_t SMEM = 1024 + BSTAGES * 2 * BTILE + CSTAGES * ATILE +
                        sizeof(Small);

__device__ __forceinline__ char* aligned_smem(char* raw) {
  const uint32_t pad = (1024 - (hopper::smem_u32(raw) & 1023)) & 1023;
  return raw + pad;
}

// a B tile element: line l, channel i of the chunk (core matrices of 8
// lines x 4 channels, the channel groups LT lines apart)
__device__ __forceinline__ uint32_t b_off(int l, int i) {
  return (i >> 2) * (LT * 16u) + l * 16u + (i & 3) * 4u;
}

// the query and position of line L (tile lines from the column tile's
// first shift): queries `span` lines apart at m <= ROWS; past the block's
// queries, a position far off
__device__ __forceinline__ void line_pos(const Args& a, int nq, int rt,
                                         int L, int& ql, int& p) {
  const int pl = (a.K - 1) / 2;
  if (a.m <= ROWS) {
    ql = L / a.span;
    p = L - ql * a.span - pl;
    if (ql >= nq) p = INT_MIN / 2;
  } else {
    ql = 0;
    p = rt * ROWS + L - pl;
  }
}

// conv 1 from global memory (rows that do not fit in shared memory, or K >
// KT): query ql at position p (0 outside [0, m)), channel c
__device__ __forceinline__ float conv1_global(const Args& a, const float* qb,
                                              const float* c1f, int ql,
                                              int p, int c) {
  if (p < 0 || p >= a.m || c >= a.C) return 0.f;
  const int pl = (a.K - 1) / 2;
  const float* xr = qb + static_cast<size_t>(ql) * a.m + p - pl;
  const int k0 = max(0, pl - p), k1 = min(a.K, a.m + pl - p);
  float h = 0.f;
  for (int k = k0; k < k1; ++k)
    h = fmaf(__ldg(xr + k), __ldg(c1f + static_cast<size_t>(k) * a.C + c), h);
  return h;
}

// the producer: a chunk's B tile (conv 1, raw and lo), then its shifts' c2
// tiles; each loader arrives once on a stage's full barrier (its B stores,
// after the proxy fence; its c2 copies, as they land)
__device__ __forceinline__ void produce(const Args& a, char* smem, Small& s,
                                        int f, int q0, int nq, int ptid) {
  const int m = a.m, K = a.K, C = a.C, pl = (K - 1) / 2;
  const int rtiles = m <= ROWS ? 1 : (m + ROWS - 1) / ROWS;
  const int passes = (C + OW - 1) / OW, chunks = (C + TK - 1) / TK;
  const int groups = (K + KT - 1) / KT;
  const float* qb = a.q + static_cast<size_t>(q0) * m;
  const float* c1f = a.c1 + static_cast<size_t>(f) * K * C;
  const float* c2f = a.c2 + static_cast<size_t>(f) * K * C * C;
  // the block's query rows with their zeros, where they fit: conv 1 then
  // reads no global memory and tests no bounds
  const int xlen = m <= ROWS ? nq * a.span : m + K - 1;
  const bool staged = K <= KT && xlen <= XS_MAX;
  if (staged)
    for (int e = ptid; e < xlen; e += LOADERS) {
      const int ql = m <= ROWS ? e / a.span : 0;
      const int p = e - ql * (m <= ROWS ? a.span : 0) - pl;
      s.xs[e] = p >= 0 && p < m ? __ldg(qb + static_cast<size_t>(ql) * m + p)
                                : 0.f;
    }
  char* bring = smem;
  char* cring = smem + BSTAGES * 2 * BTILE;
  int bit = 0, cit = 0;
  for (int rt = 0; rt < rtiles; ++rt) {
    hopper::bar_sync(BAR_LOAD, LOADERS);  // the last tile's loff is read
    if (staged)
      for (int l = ptid; l < LT; l += LOADERS) {
        int ql, p;
        line_pos(a, nq, rt, l, ql, p);
        s.loff[l] = p >= 0 && p < m ? (m <= ROWS ? ql * a.span : 0) + p : -1;
      }
    for (int op = 0; op < passes; ++op)
      for (int ch = 0; ch < chunks; ++ch)
        for (int g = 0; g < groups; ++g) {
          const int i0 = ch * TK, o0 = op * OW, k0 = g * KT;
          const int nk = min(KT, K - k0);
          hopper::bar_sync(BAR_LOAD, LOADERS);  // c1s of the last tile read
          if (staged)
            for (int e = ptid; e < K * TK; e += LOADERS)
              s.c1s[e / TK][e % TK] =
                  i0 + e % TK < C ? __ldg(c1f + (e / TK) * C + i0 + e % TK)
                                  : 0.f;
          hopper::bar_sync(BAR_LOAD, LOADERS);  // loff and c1s are written
          const int bslot = bit % BSTAGES;
          hopper::mbar_wait(&s.bempty[bslot], ((bit / BSTAGES) & 1) ^ 1);
          char* braw = bring + bslot * 2 * BTILE;
          // line l, channels 4 kg .. 4 kg + 3: consecutive threads take
          // consecutive lines (16-byte stores, no bank conflict)
          for (int e = ptid; e < (TK / 4) * LT; e += LOADERS) {
            const int kg = e / LT, l = e - kg * LT;
            float h[4] = {0.f, 0.f, 0.f, 0.f};
            if (staged) {
              const int off = s.loff[l];
              if (off >= 0) {
                for (int k = 0; k < K; ++k) {
                  const float x = s.xs[off + k];
                  const float4 cv =
                      *reinterpret_cast<const float4*>(&s.c1s[k][4 * kg]);
                  h[0] = fmaf(x, cv.x, h[0]);
                  h[1] = fmaf(x, cv.y, h[1]);
                  h[2] = fmaf(x, cv.z, h[2]);
                  h[3] = fmaf(x, cv.w, h[3]);
                }
              }
            } else {
              int ql, p;
              line_pos(a, nq, rt, k0 + l, ql, p);
#pragma unroll 1
              for (int j = 0; j < 4; ++j)
                h[j] = conv1_global(a, qb, c1f, ql, p, i0 + 4 * kg + j);
            }
            float lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              h[j] = fmaxf(h[j], 0.f);
              lo[j] = h[j] - __uint_as_float(__float_as_uint(h[j]) &
                                             0xffffe000u);
            }
            const uint32_t off = b_off(l, 4 * kg);
            *reinterpret_cast<float4*>(braw + off) =
                make_float4(h[0], h[1], h[2], h[3]);
            *reinterpret_cast<float4*>(braw + BTILE + off) =
                make_float4(lo[0], lo[1], lo[2], lo[3]);
          }
          hopper::fence_proxy_async();      // B is read by the tensor cores
          hopper::mbar_arrive(&s.bfull[bslot]);
          ++bit;
          // c2[f, k, i0 .. i0 + TK, o0 .. o0 + OW] -> [TK][LDA], a shift a
          // stage
          for (int k = k0; k < k0 + nk; ++k, ++cit) {
            const int cslot = cit % CSTAGES;
            hopper::mbar_wait(&s.cempty[cslot], ((cit / CSTAGES) & 1) ^ 1);
            float* at = reinterpret_cast<float*>(cring + cslot * ATILE);
            const float* src =
                c2f + (static_cast<size_t>(k) * C + i0) * C + o0;
            if (a.vec) {
              for (int e = ptid; e < TK * OW / 4; e += LOADERS) {
                const int i = e / (OW / 4), c = (e % (OW / 4)) * 4;
                const bool ok = i0 + i < C && o0 + c < C;
                tf32x3::cp_async16(at + i * LDA + c,
                                   ok ? src + static_cast<size_t>(i) * C + c
                                      : a.c2,
                                   ok);
              }
              hopper::cp_async_arrive(&s.cfull[cslot]);
            } else {
              for (int e = ptid; e < TK * OW; e += LOADERS) {
                const int i = e / OW, c = e % OW;
                at[i * LDA + c] =
                    i0 + i < C && o0 + c < C
                        ? __ldg(src + static_cast<size_t>(i) * C + c)
                        : 0.f;
              }
              hopper::mbar_arrive(&s.cfull[cslot]);
            }
          }
        }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc += c2^T[the warpgroup's 64 channels] . B over one shift: per k8 step
// the A fragment read from the c2 tile and split, then its three products
// (one k8 step at a time: more A registers in flight make ptxas serialize
// the wgmmas).  B for shift `sh` of the tile starts sh lines further on.
// Warp w, lane 4g + t holds acc[4j + e] = h2^T[channel 16w + g + 8(e /
// 2)][column 8j + 2t + e % 2].
__device__ __forceinline__ void shift_products(float (&acc)[128],
                                               const char* braw,
                                               const float* at, int sh,
                                               int c, int wl, int g, int t) {
  const float* ap = at + c * 64 + 16 * wl + g + t * LDA;
#pragma unroll
  for (int k8 = 0; k8 < TK / 8; ++k8) {
    uint32_t ah[4], al[4];
    const float* p = ap + k8 * 8 * LDA;
    tf32x3::split(p[0], ah[0], al[0]);
    tf32x3::split(p[8], ah[1], al[1]);
    tf32x3::split(p[4 * LDA], ah[2], al[2]);
    tf32x3::split(p[4 * LDA + 8], ah[3], al[3]);
    const char* b = braw + (2 * k8) * (LT * 16) + sh * 16;
    const uint64_t dh = hopper::desc_noswz(b, LT * 16, 128);
    const uint64_t dl = hopper::desc_noswz(b + BTILE, LT * 16, 128);
    hopper::wgmma_fence();
    hopper::wgmma_n256(acc, al, dh, 1);
    hopper::wgmma_n256(acc, ah, dl, 1);
    hopper::wgmma_n256(acc, ah, dh, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
}

__device__ __forceinline__ void consume(const Args& a, char* smem, Small& s,
                                        int f, int nq, int wg) {
  const int m = a.m, K = a.K, C = a.C;
  const int rtiles = m <= ROWS ? 1 : (m + ROWS - 1) / ROWS;
  const int passes = (C + OW - 1) / OW, chunks = (C + TK - 1) / TK;
  const int groups = (K + KT - 1) / KT;
  const int c = wg - 1, ct = threadIdx.x - 128 * wg;
  const int ctid = threadIdx.x - 128;   // 0 .. 255 over both warpgroups
  const int wl = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const float* wf = a.w + static_cast<size_t>(f) * C;
  const char* bring = smem;
  const char* cring = smem + BSTAGES * 2 * BTILE;
  if (ctid < nq) s.zacc[ctid] = 0.f;
  int bit = 0, cit = 0;
  for (int rt = 0; rt < rtiles; ++rt) {
    for (int op = 0; op < passes; ++op) {
      const int ob = op * OW + c * 64;  // the warpgroup's first channel
      const bool live = ob < C;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int ch = 0; ch < chunks; ++ch)
        for (int gi = 0; gi < groups; ++gi, ++bit) {
          const int bslot = bit % BSTAGES;
          const int nk = min(KT, K - gi * KT);
          hopper::mbar_wait(&s.bfull[bslot], (bit / BSTAGES) & 1);
          for (int sh = 0; sh < nk; ++sh, ++cit) {
            const int cslot = cit % CSTAGES;
            hopper::mbar_wait(&s.cfull[cslot], (cit / CSTAGES) & 1);
            hopper::fence_proxy_async();
            if (live)
              shift_products(acc, bring + bslot * 2 * BTILE,
                             reinterpret_cast<const float*>(cring +
                                                            cslot * ATILE),
                             sh, c, wl, g, t);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&s.cempty[cslot]);
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&s.bempty[bslot]);
        }
      // relu(h2) . w over the thread's two channels, then the 8 lane
      // groups; each pass adds into the warp's row of red (own entries)
      float wv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = ob + 16 * wl + g + 8 * hh;
        wv[hh] = live && o < C ? __ldg(wf + o) : 0.f;
      }
      float z[64];
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          z[2 * j + e] = fmaf(fmaxf(acc[4 * j + 2 + e], 0.f), wv[1],
                              fmaxf(acc[4 * j + e], 0.f) * wv[0]);
#pragma unroll
      for (int q = 0; q < 64; ++q) {
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 4);
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 8);
        z[q] += __shfl_xor_sync(0xffffffffu, z[q], 16);
      }
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& o = s.red[c][wl][8 * j + 2 * t + e];
            o = op == 0 ? z[2 * j + e] : o + z[2 * j + e];
          }
    }
    hopper::bar_sync(BAR_CONS, 128 * CONSUMERS);
    float v = 0.f;
#pragma unroll
    for (int cc = 0; cc < CONSUMERS; ++cc)
#pragma unroll
      for (int w = 0; w < 4; ++w) v += s.red[cc][w][ctid];
    s.rowsum[ctid] = v;
    hopper::bar_sync(BAR_CONS, 128 * CONSUMERS);
    // each query adds its columns of this tile in increasing position
    if (ctid < nq) {
      const int first = m <= ROWS ? ctid * a.span : 0;
      const int n = m <= ROWS ? m : min(ROWS, m - rt * ROWS);
      float tz = s.zacc[ctid];
      for (int p = 0; p < n; ++p) tz += s.rowsum[first + p];
      s.zacc[ctid] = tz;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) cnn_filter_kernel(const Args a) {
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  Small& s = *reinterpret_cast<Small*>(smem + BSTAGES * 2 * BTILE +
                                       CSTAGES * ATILE);
  const int f = static_cast<int>(blockIdx.x / a.tiles);
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * a.qt;
  const int nq = min(a.qt, a.Q - q0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < BSTAGES; ++i) {
      hopper::mbar_init(&s.bfull[i], LOADERS);
      hopper::mbar_init(&s.bempty[i], 4 * CONSUMERS);
    }
    for (int i = 0; i < CSTAGES; ++i) {
      hopper::mbar_init(&s.cfull[i], LOADERS);
      hopper::mbar_init(&s.cempty[i], 4 * CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce(a, smem, s, f, q0, nq, threadIdx.x);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  consume(a, smem, s, f, nq, wg);
  const int i = static_cast<int>(threadIdx.x) - 128;
  if (i < nq) {
    const float z = s.zacc[i] / static_cast<float>(a.m) + a.b[f];
    a.out[static_cast<size_t>(f) * a.Q + q0 + i] = z * a.y_std[f] + a.y_mean[f];
  }
}

struct Plan {
  int qt, tiles, span, vec, rtiles;
};

// queries a block: at m <= ROWS as many as fit, m + K - 1 columns apart,
// with the last one's m columns inside the tile
Plan plan(int Q, int m, int K, int C, const void* c2) {
  Plan p;
  p.span = m + K - 1;
  p.qt = m <= ROWS ? (ROWS - m) / p.span + 1 : 1;
  p.tiles = (Q + p.qt - 1) / p.qt;
  p.vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(c2) % 16 == 0;
  p.rtiles = m <= ROWS ? 1 : (m + ROWS - 1) / ROWS;
  return p;
}

}  // namespace

// queries (Q, m), c1 (F, K, 1, C), c2 (F, K, C, C), w (F, C), b, y_mean,
// y_std (F,), all float32 and contiguous → out (F, Q) float32.
extern "C" int cnn_filter(const void* queries, const void* c1, const void* c2,
                          const void* w, const void* b, const void* y_mean,
                          const void* y_std, void* out, int F, int Q, int m,
                          int K, int C, void* stream) {
  if (F <= 0 || Q <= 0 || m <= 0 || K <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const Plan p = plan(Q, m, K, C, c2);
  const long long blocks = static_cast<long long>(F) * p.tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      cnn_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float*>(queries),
               static_cast<const float*>(c1),
               static_cast<const float*>(c2),
               static_cast<const float*>(w),
               static_cast<const float*>(b),
               static_cast<const float*>(y_mean),
               static_cast<const float*>(y_std),
               static_cast<float*>(out),
               Q,
               m,
               K,
               C,
               p.qt,
               p.tiles,
               p.span,
               p.vec};
  cnn_filter_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launch the entry makes for (F, Q, m, K, C) and a c2 whose address is
// 16-byte aligned or not: {queries a block, columns a tile, channels a
// pass, B tiles a block (column tiles x passes x channel chunks x shift
// groups), c2 stages a block (... x K), c2 staged by 16-byte cp.async,
// dynamic shared memory bytes, registers a thread at launch, c2 bytes the
// grid stages from L2}.
extern "C" int cnn_filter_layout(int F, int Q, int m, int K, int C,
                                 int c2_aligned, long long* out) {
  if (F <= 0 || Q <= 0 || m <= 0 || K <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const Plan p = plan(Q, m, K, C,
                      c2_aligned ? nullptr : reinterpret_cast<void*>(4));
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, cnn_filter_kernel);
  if (err != cudaSuccess) return err;
  const long long passes = (C + OW - 1) / OW, chunks = (C + TK - 1) / TK;
  const long long groups = (K + KT - 1) / KT;
  out[0] = p.qt;
  out[1] = ROWS;
  out[2] = OW;
  out[3] = p.rtiles * passes * chunks * groups;
  out[4] = p.rtiles * passes * chunks * K;
  out[5] = p.vec;
  out[6] = static_cast<long long>(SMEM);
  out[7] = attr.numRegs;
  out[8] = static_cast<long long>(F) * p.tiles * p.rtiles * K * C * C * 4;
  return cudaSuccess;
}
