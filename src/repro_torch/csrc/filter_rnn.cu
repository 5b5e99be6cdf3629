// The 2-block LSTM filter backbone for Hopper (sm_90a): every filter's
// de-standardized prediction for every query, (F, Q), in one launch.
//
// Replaces no Pallas kernel: the reference computes the LSTM filters of its
// Table 1 / Fig. 12 ablation in XLA (src/repro/core/filters.py:233
// apply_rnn; each layer a lax.scan, :215 _lstm_layer, under a vmap over
// filters).  For filter f and query x (m values), two bias-free LSTM
// layers of h units from zero state, gates in i, f, g, o order:
//   layer 1 at step t:  G = x[t] * wi1 + h1 . wh1            (4h)
//   layer 2 at step t:  G = h1 . wi2 + h2 . wh2              (4h)
//   each:  c = sig(G_f) * c + sig(G_i) * tanh(G_g),  h = sig(G_o) * tanh(c)
//   out[f, q] = (h2 after step m - 1) . w + b, then * y_std + y_mean.
// sig(v) = 1 / (1 + expf(-v)); expf and tanhf, not the fast intrinsics.
//
// Bound on an H100: 3 * h * 4h multiply-adds a step, ~98,816 FLOP at h =
// 64 with the cell updates, 25.3 MFLOP a (filter, query) pair at m = 256;
// at F = 4096 and the 180 calibration queries 1.87e13 FLOP, ~0.28 s at the
// 67 TFLOP/s float32 CUDA-core peak (Q = 1: ~1.5 ms), while the weights
// are 0.81 GB (~0.24 ms at 3.35 TB/s): operations bound it.  The m steps
// of a layer are a chain, and layer 2's step t needs layer 1's step t.
//
// Three instances, by (h, Q) (`plan`):
//   * few (h = 32, 64 and Q <= FEW_MAX_Q): a block of 3h^2/32 threads (384
//     at h = 64) per (filter, query) holds all three h x 4h weights in
//     registers, 128 floats a thread: a thread owns two units' four gates
//     (8 sums) over a slice of 16 inputs (4 float4 groups, group is + S j
//     of the layer's inputs, S = h/16 slices for layer 1 and h/8 for
//     layer 2, whose inputs are h1 then h2), so each step reads only the
//     state, broadcast from shared memory.  The S slices of a pair are
//     lanes of one warp: the first shuffle level (xor S/2) sends one
//     unit's sums and keeps the other's, the later levels add, in a fixed
//     tree; the lanes of a unit then hold its four gates and update its
//     cell (c in registers).  One barrier a step: layer 1's step t + 1 and
//     layer 2's step t run together, both reading h1 after step t.
//   * many (h = 32, 64 and Q > FEW_MAX_Q): a block of 3h^2/32 threads per
//     (filter, QB = 16 queries), the three weights in shared memory as
//     [i][u][gate] (196,608 bytes at h = 64).  A thread owns one unit's
//     four gates for all QB queries over a slice of 32 inputs (input is +
//     S j, S = h/32 slices for layer 1, h/16 for layer 2), so each weight
//     is read from shared memory once a step for all the block's queries
//     (one float4 for 64 multiply-adds); the slices reduce-scatter the
//     queries by shuffles in the same tree, QB/S queries a lane, whose
//     cells it keeps.  Layers overlap as in few.
//   * generic (any other h): a block of 256 threads per (filter, query
//     tile); a thread owns one unit u of every h-unit slice it covers (u,
//     u + U, ... with U = min(h, 256)) for QPT = 4 queries: G = 256 / U
//     query groups, qt = 4 G queries a block.  The gates' sums run over
//     the inputs in increasing order.  Layer 2's step t follows layer 1's
//     step t (two barriers a step); h1 and h2 are double-buffered ([h][qt])
//     and c kept beside them.  The weights sit in shared memory where they
//     fit beside the state (relaid [i][u][gate]), else are read through L2
//     (four loads an input), and where the state does not fit either it
//     lives in a global scratch row per block.  A query group with no
//     valid query skips its products.
// Every instance sums h2 . w over the units in increasing order, one
// thread a query, and repeats bitwise (no float atomics).

#include <cuda_runtime.h>

#include <climits>

namespace {

#ifndef LSTM_FEW_MAX_Q
#define LSTM_FEW_MAX_Q 8
#endif
constexpr int FEW_MAX_Q = LSTM_FEW_MAX_Q;   // few-query instance up to this Q
constexpr int QB = 16;      // queries a block of the many-query instance
constexpr int LDQ = QB + 4; // its state rows (floats): conflict-free reads
constexpr int GTHREADS = 256;
constexpr int QPT = 4;      // queries a thread of the generic instance

struct Args {
  const float* q;       // (Q, m)
  const float* wi1;     // (F, 1, 4h)
  const float* wh1;     // (F, h, 4h)
  const float* wi2;     // (F, h, 4h)
  const float* wh2;     // (F, h, 4h)
  const float* w;       // (F, h)
  const float* b;       // (F,)
  const float* y_mean;  // (F,)
  const float* y_std;   // (F,)
  float* out;           // (F, Q)
  float* scratch;       // generic: blocks x 6 qt h floats (state in memory)
  int Q, m, h;
  int U;                // generic: units a slice, min(h, GTHREADS)
  int G;                // generic: query groups, GTHREADS / U
  int qt;               // queries a block
  int tiles;            // query tiles a filter
};

// 1 / (1 + expf(-v)) as a correctly rounded reciprocal: the division's
// result bit for bit, without its slow path
__device__ __forceinline__ float sigm(float v) {
  return __frcp_rn(1.f + expf(-v));
}

// the cell of one unit from its gate sums (i, f, g, o): c updated, h out
__device__ __forceinline__ float cell1(float gi, float gf, float gg, float go,
                                       float& c) {
  c = sigm(gf) * c + sigm(gi) * tanhf(gg);
  return sigm(go) * tanhf(c);
}

// ---- few: the weights in registers ---------------------------------------

// a thread of layer L (1 or 2) of the few-query instance: slices S, its
// pair of units and its slice; w[j * 4 + r][k] is the weight of input
// 4 (is + S j) + r for sum k = unit (k / 4) of the pair, gate k % 4
template <int H, int S>
__device__ __forceinline__ void few_load(float (&w)[16][8], const float* wa,
                                         const float* wb, int pair, int is) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (is + S * j) + r;
      const float* row = i < H ? wa + static_cast<size_t>(i) * 4 * H
                               : wb + static_cast<size_t>(i - H) * 4 * H;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[j * 4 + r][k] = __ldg(row + (k % 4) * H + 2 * pair + k / 4);
    }
}

// the 8 sums over the S lanes of a pair: the first level (xor S/2) keeps
// the sums of unit `upper`, the later ones add; returns the unit's gates
template <int S>
__device__ __forceinline__ void few_reduce(float (&acc)[8], float (&v)[4],
                                           bool upper) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = upper ? acc[k] : acc[4 + k];
    const float keep = upper ? acc[4 + k] : acc[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, S / 2);
  }
#pragma unroll
  for (int d = S / 4; d >= 1; d /= 2)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], d);
}

template <int H>
__global__ void __launch_bounds__(3 * H * H / 32, 1)
lstm_few_kernel(const Args a) {
  constexpr int S1 = H / 16, S2 = H / 8;
  constexpr int T1 = H / 2 * S1;        // layer 1's threads, then layer 2's
  __shared__ __align__(16) float hs[2][2][H];   // [layer][buffer][unit]
  __shared__ float wi1s[4 * H];
  const int tid = threadIdx.x;
  const int f = static_cast<int>(blockIdx.x / a.Q);
  const int qi = static_cast<int>(blockIdx.x % a.Q);
  const int m = a.m;
  const size_t hh4 = static_cast<size_t>(H) * 4 * H;
  const bool l1 = tid < T1;
  const int gt = l1 ? tid : tid - T1;
  const int S = l1 ? S1 : S2;
  const int pair = gt / S, is = gt % S;
  const bool upper = (is & (S / 2)) != 0;
  const int u = 2 * pair + upper;
  const bool writer = (is & (S / 2 - 1)) == 0;
  for (int e = tid; e < 4 * H; e += blockDim.x) {
    wi1s[e] = __ldg(a.wi1 + static_cast<size_t>(f) * 4 * H + e);
    (&hs[0][0][0])[e] = 0.f;
  }
  float w[16][8];
  if (l1)
    few_load<H, S1>(w, a.wh1 + f * hh4, a.wh1 + f * hh4, pair, is);
  else
    few_load<H, S2>(w, a.wi2 + f * hh4, a.wh2 + f * hh4, pair, is);
  __syncthreads();
  const float* xr = a.q + static_cast<size_t>(qi) * m;
  float x = l1 ? __ldg(xr) : 0.f;
  float c = 0.f;
  // iteration tau: layer 1's step tau beside layer 2's step tau - 1, both
  // reading h1 after step tau - 1; one barrier an iteration
  for (int tau = 0; tau <= m; ++tau) {
    const int cur = tau & 1, prev = cur ^ 1;
    const float xn = l1 && tau + 1 < m ? __ldg(xr + tau + 1) : 0.f;
    float acc[8];
    if (l1 ? tau < m : tau > 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] = l1 && is == 0 ? x * wi1s[(k % 4) * H + 2 * pair + k / 4]
                               : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // layer 2's inputs are h1 then h2: its groups j = 0, 1 lie in h1
        const int grp = is + (l1 ? S1 : S2) * j;
        const float* src = l1 || j < 2 ? hs[0][prev] + 4 * grp
                                       : hs[1][prev] + 4 * grp - H;
        const float4 hv4 = *reinterpret_cast<const float4*>(src);
        const float hv[4] = {hv4.x, hv4.y, hv4.z, hv4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[k] = fmaf(hv[r], w[j * 4 + r][k], acc[k]);
      }
      float v[4];
      if (l1)
        few_reduce<S1>(acc, v, upper);
      else
        few_reduce<S2>(acc, v, upper);
      const float hn = cell1(v[0], v[1], v[2], v[3], c);
      if (writer) hs[l1 ? 0 : 1][cur][u] = hn;
    }
    x = xn;
    __syncthreads();
  }
  if (tid == 0) {
    const float* h2 = hs[1][m & 1];
    const float* wf = a.w + static_cast<size_t>(f) * H;
    float z = 0.f;
    for (int k = 0; k < H; ++k) z = fmaf(h2[k], __ldg(wf + k), z);
    a.out[static_cast<size_t>(f) * a.Q + qi] =
        (z + a.b[f]) * a.y_std[f] + a.y_mean[f];
  }
}

// ---- many: the weights in shared memory, read once a step ---------------

// a layer's products over the thread's 32 inputs (is + S j) for all QB
// queries: weights [i][u][gate] at ws (and wb for inputs past H), state
// rows of LDQ at sa (and sb past H)
template <int H, int S>
__device__ __forceinline__ void many_products(float (&acc)[4][QB],
                                              const float* wa, const float* wb,
                                              const float* sa, const float* sb,
                                              int u, int is) {
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const int i = is + S * j;
    const bool lo = S * 32 == H || j < 16;    // layer 2: h1 rows, then h2
    const float4 wq = *reinterpret_cast<const float4*>(
        (lo ? wa + (static_cast<size_t>(i) * H + u) * 4
            : wb + (static_cast<size_t>(i - H) * H + u) * 4));
    const float* row = lo ? sa + i * LDQ : sb + (i - H) * LDQ;
    const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int k = 0; k < QB / 4; ++k) {
      const float4 h4 = *reinterpret_cast<const float4*>(row + 4 * k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[g][4 * k + e] = fmaf(hv[e], wv[g], acc[g][4 * k + e]);
    }
  }
}

// one level of the slices' reduce-scatter over the queries: the lane keeps
// the lower HALF of its live queries where is & D is 0, else the upper,
// and adds its partner's (lane is ^ D)
template <int D, int HALF>
__device__ __forceinline__ void scatter_level(float (&acc)[4][QB], int is) {
  const bool upper = (is & D) != 0;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float send = upper ? acc[g][k] : acc[g][HALF + k];
      const float keep = upper ? acc[g][HALF + k] : acc[g][k];
      acc[g][k] = keep + __shfl_xor_sync(0xffffffffu, send, D);
    }
}

// the S slices' reduce-scatter, levels D = S/2 .. 1: lane is ends with
// queries is QB/S .. (is + 1) QB/S - 1 of its unit, in acc[.][0 .. QB/S)
template <int S>
__device__ __forceinline__ void many_reduce(float (&acc)[4][QB], int is) {
  if constexpr (S >= 2) scatter_level<S / 2, QB / 2>(acc, is);
  if constexpr (S >= 4) scatter_level<S / 4, QB / 4>(acc, is);
  if constexpr (S >= 8) scatter_level<S / 8, QB / 8>(acc, is);
}

template <int H>
__global__ void __launch_bounds__(3 * H * H / 32, 1)
lstm_many_kernel(const Args a) {
  constexpr int S1 = H / 32, S2 = H / 16;
  constexpr int T1 = H * S1;
  constexpr int NK = QB / (S1 > 1 ? S1 : 1);    // a layer-1 lane's queries
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                              // 3 x [H][H][4]
  float* st = smem + 3 * H * H * 4;               // [layer][buffer][H][LDQ]
  float* xs = st + 4 * H * LDQ;                   // [buffer][QB]: x at a step
  const int tid = threadIdx.x;
  const int f = static_cast<int>(blockIdx.x / a.tiles);
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * QB;
  const int nq = min(QB, a.Q - q0);
  const int m = a.m;
  const size_t hh4 = static_cast<size_t>(H) * 4 * H;
  {
    const float* src[3] = {a.wh1 + f * hh4, a.wi2 + f * hh4, a.wh2 + f * hh4};
#pragma unroll
    for (int l = 0; l < 3; ++l)
      for (int e = tid; e < 4 * H * H; e += blockDim.x) {
        const int i = e / (4 * H), col = e - i * 4 * H;
        const int gate = col / H, uu = col - gate * H;
        wsm[l * 4 * H * H + (i * H + uu) * 4 + gate] = __ldg(src[l] + e);
      }
    for (int e = tid; e < 4 * H * LDQ; e += blockDim.x) st[e] = 0.f;
    if (tid < QB)
      xs[tid] = tid < nq ? __ldg(a.q + static_cast<size_t>(q0 + tid) * m)
                         : 0.f;
  }
  const bool l1 = tid < T1;
  const int gt = l1 ? tid : tid - T1;
  const int S = l1 ? S1 : S2;
  const int u = gt / S, is = gt % S;
  const int nk = QB / S;                          // the lane's queries
  const int qoff = is * nk;
  float wx[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    wx[g] = l1 && is == 0 ? __ldg(a.wi1 + static_cast<size_t>(f) * 4 * H +
                                  g * H + u)
                          : 0.f;
  __syncthreads();
  float c[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) c[k] = 0.f;
  // the last QB threads fetch the next step's x into xs (one each)
  const int xq = tid - (static_cast<int>(blockDim.x) - QB);
  // iteration tau: layer 1's step tau beside layer 2's step tau - 1, as in
  // few
  for (int tau = 0; tau <= m; ++tau) {
    const int cur = tau & 1, prev = cur ^ 1;
    float* h1p = st + (0 * 2 + prev) * H * LDQ;
    float* h2p = st + (1 * 2 + prev) * H * LDQ;
    const float xn = xq >= 0 && xq < nq && tau + 1 < m
                         ? __ldg(a.q + static_cast<size_t>(q0 + xq) * m +
                                 tau + 1)
                         : 0.f;
    if (l1 ? tau < m : tau > 0) {
      float acc[4][QB];
      const float* xr = xs + cur * QB;            // x at step tau
#pragma unroll
      for (int k = 0; k < QB; k += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr + k);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][k + e] = xv[e] * wx[g];
      }
      if (l1) {
        many_products<H, S1>(acc, wsm, wsm, h1p, h1p, u, is);
        many_reduce<S1>(acc, is);
      } else {
        many_products<H, S2>(acc, wsm + 4 * H * H, wsm + 8 * H * H, h1p,
                             h2p, u, is);
        many_reduce<S2>(acc, is);
      }
      float* hn = st + ((l1 ? 0 : 1) * 2 + cur) * H * LDQ + u * LDQ + qoff;
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (k < nk)
          hn[k] = cell1(acc[0][k], acc[1][k], acc[2][k], acc[3][k], c[k]);
    }
    if (xq >= 0) xs[(cur ^ 1) * QB + xq] = xn;
    __syncthreads();
  }
  if (tid < nq) {
    const float* h2 = st + (1 * 2 + (m & 1)) * H * LDQ + tid;
    const float* wf = a.w + static_cast<size_t>(f) * H;
    float z = 0.f;
    for (int k = 0; k < H; ++k) z = fmaf(h2[k * LDQ], __ldg(wf + k), z);
    a.out[static_cast<size_t>(f) * a.Q + q0 + tid] =
        (z + a.b[f]) * a.y_std[f] + a.y_mean[f];
  }
}

// ---- generic: today's instance for any h ---------------------------------

// the four gate weights of unit u for input i: shared [i][u][gate] or the
// global (i, 4h) row
template <bool W_SMEM>
__device__ __forceinline__ float4 gate_w(const float* ws, const float* wg,
                                         int i, int u, int h) {
  if (W_SMEM)
    return *reinterpret_cast<const float4*>(
        ws + (static_cast<size_t>(i) * h + u) * 4);
  const float* p = wg + static_cast<size_t>(i) * 4 * h + u;
  return make_float4(__ldg(p), __ldg(p + h), __ldg(p + 2 * h),
                     __ldg(p + 3 * h));
}

__device__ __forceinline__ void fma_quad(float (&acc)[4][QPT], float4 w,
                                         float4 x) {
  const float wv[4] = {w.x, w.y, w.z, w.w};
  const float xv[QPT] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[g][j] = fmaf(xv[j], wv[g], acc[g][j]);
}

// c and h of the thread's cells of unit u from the gate sums
__device__ __forceinline__ void cell(const float (&acc)[4][QPT], float* c,
                                     float* hn) {
  float cv[QPT], hv[QPT];
  const float4 c4 = *reinterpret_cast<const float4*>(c);
  const float cold[QPT] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    cv[j] = sigm(acc[1][j]) * cold[j] + sigm(acc[0][j]) * tanhf(acc[2][j]);
    hv[j] = sigm(acc[3][j]) * tanhf(cv[j]);
  }
  *reinterpret_cast<float4*>(c) = make_float4(cv[0], cv[1], cv[2], cv[3]);
  *reinterpret_cast<float4*>(hn) = make_float4(hv[0], hv[1], hv[2], hv[3]);
}

template <bool W_SMEM, bool S_SMEM>
__global__ void __launch_bounds__(GTHREADS, 1) lstm_generic_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int f = static_cast<int>(blockIdx.x / a.tiles);
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * a.qt;
  const int nq = min(a.qt, a.Q - q0);
  const int h = a.h, qt = a.qt, m = a.m;
  const size_t hh4 = static_cast<size_t>(h) * 4 * h;
  const float* wh1g = a.wh1 + f * hh4;
  const float* wi2g = a.wi2 + f * hh4;
  const float* wh2g = a.wh2 + f * hh4;
  const float* wi1g = a.wi1 + static_cast<size_t>(f) * 4 * h;

  float* wsm = smem;                                    // 3 x [h][h][4]
  float* st = S_SMEM ? smem + (W_SMEM ? 3 * hh4 : 0)
                     : a.scratch + static_cast<size_t>(blockIdx.x) * 6 * qt * h;
  const size_t hq = static_cast<size_t>(h) * qt;
  float* H1 = st;               // [2][h][qt]
  float* H2 = st + 2 * hq;      // [2][h][qt]
  float* C1 = st + 4 * hq;      // [h][qt]
  float* C2 = st + 5 * hq;      // [h][qt]

  if (W_SMEM) {
    // relay (i, gate * h + u) as [i][u][gate]
    const float* src[3] = {wh1g, wi2g, wh2g};
#pragma unroll
    for (int l = 0; l < 3; ++l)
      for (size_t e = tid; e < hh4; e += GTHREADS) {
        const int i = static_cast<int>(e / (4 * h));
        const int col = static_cast<int>(e - static_cast<size_t>(i) * 4 * h);
        const int gate = col / h, u = col - gate * h;
        wsm[l * hh4 + (static_cast<size_t>(i) * h + u) * 4 + gate] =
            __ldg(src[l] + e);
      }
  }
  for (size_t e = tid; e < 6 * hq; e += GTHREADS) st[e] = 0.f;
  __syncthreads();

  const int U = a.U;
  const int g = tid / U, u0 = tid - g * U;
  const int qg = g * QPT;                   // the thread's first query slot
  const bool active = g < a.G && qg < nq;
  const float* xrow[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j)
    xrow[j] = q0 + qg + j < a.Q ? a.q + static_cast<size_t>(q0 + qg + j) * m
                                : nullptr;

  for (int t = 0; t < m; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* h1c = H1 + cur * hq;
    float* h1n = H1 + nxt * hq;
    const float* h2c = H2 + cur * hq;
    float* h2n = H2 + nxt * hq;
    if (active) {
      float xt[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) xt[j] = xrow[j] ? __ldg(xrow[j] + t) : 0.f;
      for (int u = u0; u < h; u += U) {
        float acc[4][QPT];
        const float* wi = wi1g + u;
        const float wx[4] = {__ldg(wi), __ldg(wi + h), __ldg(wi + 2 * h),
                             __ldg(wi + 3 * h)};
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc[gg][j] = xt[j] * wx[gg];
        for (int i = 0; i < h; ++i)
          fma_quad(acc, gate_w<W_SMEM>(wsm, wh1g, i, u, h),
                   *reinterpret_cast<const float4*>(h1c + i * qt + qg));
        cell(acc, C1 + static_cast<size_t>(u) * qt + qg,
             h1n + static_cast<size_t>(u) * qt + qg);
      }
    }
    __syncthreads();
    if (active) {
      for (int u = u0; u < h; u += U) {
        float acc[4][QPT];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc[gg][j] = 0.f;
        for (int i = 0; i < h; ++i)
          fma_quad(acc, gate_w<W_SMEM>(wsm + hh4, wi2g, i, u, h),
                   *reinterpret_cast<const float4*>(h1n + i * qt + qg));
        for (int i = 0; i < h; ++i)
          fma_quad(acc, gate_w<W_SMEM>(wsm + 2 * hh4, wh2g, i, u, h),
                   *reinterpret_cast<const float4*>(h2c + i * qt + qg));
        cell(acc, C2 + static_cast<size_t>(u) * qt + qg,
             h2n + static_cast<size_t>(u) * qt + qg);
      }
    }
    __syncthreads();
  }
  if (tid < nq) {
    const float* h2 = H2 + (m & 1) * hq;
    const float* wf = a.w + static_cast<size_t>(f) * h;
    float z = 0.f;
    for (int u = 0; u < h; ++u) z = fmaf(h2[static_cast<size_t>(u) * qt + tid],
                                         __ldg(wf + u), z);
    a.out[static_cast<size_t>(f) * a.Q + q0 + tid] =
        (z + a.b[f]) * a.y_std[f] + a.y_mean[f];
  }
}

using Kernel = void (*)(Args);

enum Instance { GENERIC = 0, FEW = 1, MANY = 2 };

struct Plan {
  Kernel kern;
  int instance;
  int threads;
  size_t smem;     // dynamic shared memory bytes
  int w_smem, s_smem;
  int w_regs;      // weights a thread holds in registers
  int U, G, qt;
};

Plan plan(int h, int Q) {
  Plan p{};
  if (h == 32 || h == 64) {
    p.threads = 3 * h * h / 32;
    p.s_smem = 1;
    if (Q <= FEW_MAX_Q) {
      p.instance = FEW;
      p.kern = h == 64 ? lstm_few_kernel<64> : lstm_few_kernel<32>;
      p.qt = 1;
      p.w_regs = 128;
    } else {
      p.instance = MANY;
      p.kern = h == 64 ? lstm_many_kernel<64> : lstm_many_kernel<32>;
      p.qt = QB;
      p.w_smem = 1;
      p.smem = (3ull * 4 * h * h + 4ull * h * LDQ + 2 * QB) * sizeof(float);
    }
    return p;
  }
  p.instance = GENERIC;
  p.threads = GTHREADS;
  p.U = h < GTHREADS ? h : GTHREADS;
  p.G = GTHREADS / p.U;
  p.qt = p.G * QPT;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t state = 6ull * p.qt * h * sizeof(float);
  const size_t weights = 3ull * 4 * h * h * sizeof(float);
  if (weights + state <= static_cast<size_t>(optin)) {
    p.kern = lstm_generic_kernel<true, true>;
    p.smem = weights + state;
    p.w_smem = p.s_smem = 1;
  } else if (state <= static_cast<size_t>(optin)) {
    p.kern = lstm_generic_kernel<false, true>;
    p.smem = state;
    p.w_smem = 0;
    p.s_smem = 1;
  } else {
    p.kern = lstm_generic_kernel<false, false>;
    p.smem = 0;
    p.w_smem = p.s_smem = 0;
  }
  return p;
}

}  // namespace

// queries (Q, m), wi1 (F, 1, 4h), wh1/wi2/wh2 (F, h, 4h), w (F, h), b,
// y_mean, y_std (F,), all float32 and contiguous; scratch holds
// lstm_filter_layout's scratch floats → out (F, Q) float32.
extern "C" int lstm_filter(const void* queries, const void* wi1,
                           const void* wh1, const void* wi2, const void* wh2,
                           const void* w, const void* b, const void* y_mean,
                           const void* y_std, void* out, void* scratch, int F,
                           int Q, int m, int h, void* stream) {
  if (F <= 0 || Q <= 0 || m <= 0 || h <= 0) return cudaErrorInvalidValue;
  const Plan p = plan(h, Q);
  const int tiles = (Q + p.qt - 1) / p.qt;
  const long long blocks = static_cast<long long>(F) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (!p.s_smem && scratch == nullptr) return cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  const Args a{static_cast<const float*>(queries),
               static_cast<const float*>(wi1),
               static_cast<const float*>(wh1),
               static_cast<const float*>(wi2),
               static_cast<const float*>(wh2),
               static_cast<const float*>(w),
               static_cast<const float*>(b),
               static_cast<const float*>(y_mean),
               static_cast<const float*>(y_std),
               static_cast<float*>(out),
               static_cast<float*>(scratch),
               Q,
               m,
               h,
               p.U,
               p.G,
               p.qt,
               tiles};
  p.kern<<<static_cast<unsigned>(blocks), p.threads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launch the entry makes for (F, Q, h): {instance (0 generic, 1 few, 2
// many), threads a block, queries a block, weights in shared memory,
// weights a thread holds in registers, state in shared memory, dynamic
// shared memory bytes, registers a thread, scratch floats (0 unless the
// state is in memory), the few-query instance's largest Q}.
extern "C" int lstm_filter_layout(int F, int Q, int h, long long* out) {
  if (F <= 0 || Q <= 0 || h <= 0) return cudaErrorInvalidValue;
  const Plan p = plan(h, Q);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, p.kern);
  if (err != cudaSuccess) return err;
  const long long tiles = (Q + p.qt - 1) / p.qt;
  out[0] = p.instance;
  out[1] = p.threads;
  out[2] = p.qt;
  out[3] = p.w_smem;
  out[4] = p.w_regs;
  out[5] = p.s_smem;
  out[6] = static_cast<long long>(p.smem);
  out[7] = attr.numRegs;
  out[8] = p.s_smem ? 0 : static_cast<long long>(F) * tiles * 6 * p.qt * h;
  out[9] = FEW_MAX_Q;
  return cudaSuccess;
}
