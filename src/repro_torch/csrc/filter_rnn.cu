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
// 67 TFLOP/s float32 CUDA-core peak, while the weights are 0.81 GB (~0.24
// ms at 3.35 TB/s): operations bound it.  The m steps of a layer are a
// chain, and layer 2's step t needs layer 1's step t.
//
// Design:
//   * A block of 256 threads per (filter, query tile).  A thread owns one
//     unit u of every h-unit slice it covers (u, u + U, ... with U = min(h,
//     256)) for QPT = 4 queries: G = 256 / U query groups, qt = 4 G queries
//     a block (16 at h = 64).  It computes all four gates of its cells, so
//     the cell update needs no exchange; the gates' sums run over the
//     inputs in increasing order, 16 products a step (4 gates x 4
//     queries) from one weight quad and one state quad.
//   * Layer 2's step t follows layer 1's step t in the same block, so no
//     (Q, m, h) sequence goes to memory.  h1 and h2 are double-buffered
//     ([h][qt], a query quad 16-byte aligned) and c kept beside them, two
//     barriers a step.
//   * Instances by shape: at h = 64 wh1, wi2 and wh2 sit in shared memory
//     (196,608 bytes, each relaid as [i][u][gate] so a thread's four gate
//     weights are one 16-byte load) beside the state (24 qt h bytes);
//     where they do not fit they are read through L2 (four loads an input),
//     and where the state does not fit either it lives in a global scratch
//     row per block.
//   * A query group with no valid query skips its products (it still meets
//     the barriers).  The epilogue sums h2 . w over the units in increasing
//     order, one thread a query: a call repeats bitwise.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int QPT = 4;   // queries a thread

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
  float* scratch;       // blocks x 6 qt h floats (the state in memory)
  int Q, m, h;
  int U;                // units a slice: min(h, THREADS)
  int G;                // query groups: THREADS / U
  int qt;               // queries a block: G * QPT
  int tiles;            // query tiles a filter
};

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

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
__global__ void __launch_bounds__(THREADS, 1) lstm_filter_kernel(Args a) {
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
      for (size_t e = tid; e < hh4; e += THREADS) {
        const int i = static_cast<int>(e / (4 * h));
        const int col = static_cast<int>(e - static_cast<size_t>(i) * 4 * h);
        const int gate = col / h, u = col - gate * h;
        wsm[l * hh4 + (static_cast<size_t>(i) * h + u) * 4 + gate] =
            __ldg(src[l] + e);
      }
  }
  for (size_t e = tid; e < 6 * hq; e += THREADS) st[e] = 0.f;
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

struct Plan {
  Kernel kern;
  size_t smem;     // dynamic shared memory bytes
  int w_smem, s_smem;
  int U, G, qt;
};

Plan plan(int h) {
  Plan p{};
  p.U = h < THREADS ? h : THREADS;
  p.G = THREADS / p.U;
  p.qt = p.G * QPT;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t state = 6ull * p.qt * h * sizeof(float);
  const size_t weights = 3ull * 4 * h * h * sizeof(float);
  if (weights + state <= static_cast<size_t>(optin)) {
    p.kern = lstm_filter_kernel<true, true>;
    p.smem = weights + state;
    p.w_smem = p.s_smem = 1;
  } else if (state <= static_cast<size_t>(optin)) {
    p.kern = lstm_filter_kernel<false, true>;
    p.smem = state;
    p.w_smem = 0;
    p.s_smem = 1;
  } else {
    p.kern = lstm_filter_kernel<false, false>;
    p.smem = 0;
    p.w_smem = p.s_smem = 0;
  }
  return p;
}

}  // namespace

// queries (Q, m), wi1 (F, 1, 4h), wh1/wi2/wh2 (F, h, 4h), w (F, h), b,
// y_mean, y_std (F,), all float32 and contiguous; scratch holds
// lstm_filter_scratch floats → out (F, Q) float32.
extern "C" int lstm_filter(const void* queries, const void* wi1,
                           const void* wh1, const void* wi2, const void* wh2,
                           const void* w, const void* b, const void* y_mean,
                           const void* y_std, void* out, void* scratch, int F,
                           int Q, int m, int h, void* stream) {
  if (F <= 0 || Q <= 0 || m <= 0 || h <= 0) return cudaErrorInvalidValue;
  const Plan p = plan(h);
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
  p.kern<<<static_cast<unsigned>(blocks), THREADS, p.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launch the entry makes for (F, Q, h): {weights in shared memory,
// state in shared memory, queries a block, dynamic shared memory bytes,
// registers a thread, scratch floats (0 unless the state is in memory)}.
extern "C" int lstm_filter_layout(int F, int Q, int h, long long* out) {
  if (F <= 0 || Q <= 0 || h <= 0) return cudaErrorInvalidValue;
  const Plan p = plan(h);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, p.kern);
  if (err != cudaSuccess) return err;
  const long long tiles = (Q + p.qt - 1) / p.qt;
  out[0] = p.w_smem;
  out[1] = p.s_smem;
  out[2] = p.qt;
  out[3] = static_cast<long long>(p.smem);
  out[4] = attr.numRegs;
  out[5] = p.s_smem ? 0 : static_cast<long long>(F) * tiles * 6 * p.qt * h;
  return cudaSuccess;
}
