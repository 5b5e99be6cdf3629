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
// calibration queries 7.46e13 FLOP, ~1.11 s at the 67 TFLOP/s float32
// CUDA-core peak, while the inputs are 3.2 GB of c2 (~1 ms at 3.35 TB/s):
// operations bound it.  The intermediates cannot go to memory: conv 2's
// output at calibration is F * Q * m * C floats, 193 GB.
//
// Design (float32 FMA on the CUDA cores; tensor cores are later work):
//   * A block per (filter, query tile): qt = max(1, 128 / m) queries, so
//     the block's rows, (query, position) pairs, fill 128-row tiles.  A
//     filter's blocks are adjacent in the grid, so its c2 is read from HBM
//     about once and from L2 by the rest.
//   * Conv 2 is an implicit GEMM per (128-row tile, 128-channel tile):
//     the reduction runs over the K shifts and 8-channel stages of the
//     input channels.  Stage A (128 rows x 8 channels) is conv 1's output
//     at the shifted positions, recomputed from the query rows and c1 as it
//     is staged (K multiply-adds an element against the tile's 128; no
//     (m x C) map is held anywhere); stage B is c2[f, k, i0..i0+8, o-tile]
//     (16-byte loads where C % 4 == 0 and c2 is 16-byte aligned).  Both are
//     double-buffered in shared memory; 256 threads, 8 x 8 products each.
//   * Epilogue in a fixed order, no float atomics (a call repeats
//     bitwise): each thread sums relu(h2) * w over its 8 channels a row,
//     the 16 column groups are added in order into a row total, the
//     channel tiles in order, and each query adds its rows in increasing
//     position; then / m, + b, de-standardized.
// Every K >= 1, C >= 1, m >= 1, F and Q are served by the one kernel; a
// ragged tile is zero-filled.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BM = 128;      // (query, position) rows a tile
constexpr int BN = 128;      // output channels a tile
constexpr int BK = 8;        // input channels a stage
constexpr int THREADS = 256;

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
  int vec;              // c2 rows by 16-byte loads
};

__global__ void __launch_bounds__(THREADS, 2) cnn_filter_kernel(Args a) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ float red[16][BM + 1];   // +1: no bank conflicts
  __shared__ float rowacc[BM];
  __shared__ float zacc[BM];

  const int tid = threadIdx.x;
  const int f = static_cast<int>(blockIdx.x / a.tiles);
  const int q0 = static_cast<int>(blockIdx.x % a.tiles) * a.qt;
  const int nq = min(a.qt, a.Q - q0);
  const int m = a.m, K = a.K, C = a.C;
  const int rows = nq * m;
  const int pl = (K - 1) / 2;
  const float* c1f = a.c1 + static_cast<size_t>(f) * K * C;
  const float* c2f = a.c2 + static_cast<size_t>(f) * K * C * C;
  const float* wf = a.w + static_cast<size_t>(f) * C;
  const float* qb = a.q + static_cast<size_t>(q0) * m;

  if (tid < BM) zacc[tid] = 0.f;

  const int tx = tid % 16, ty = tid / 16;
  const int st_k = tid / 32;          // the stage row a thread stages
  const int st_c = (tid % 32) * 4;    // its 4 rows of A, 4 channels of B
  const int ci_steps = (C + BK - 1) / BK;
  const int S = K * ci_steps;

  for (int r0 = 0; r0 < rows; r0 += BM) {
    // the 4 rows this thread stages: their position (far below 0 for a
    // row past the block's queries, so every position test fails) and the
    // offset of their query row
    int pj[4], xo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + st_c + j;
      const int ql = r < rows ? r / m : 0;
      pj[j] = r < rows ? r - ql * m : INT_MIN / 2;
      xo[j] = ql * m;
    }
    for (int o0 = 0; o0 < C; o0 += BN) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      float ra[4], rb[4];

      auto load = [&](int s) {
        const int k = s / ci_steps;
        const int ci = (s - k * ci_steps) * BK + st_k;
        // A: conv 1's output (relu) at the shifted positions, 0 outside
        float h[4] = {0.f, 0.f, 0.f, 0.f};
        if (ci < C) {
          for (int kk = 0; kk < K; ++kk) {
            const float cv = __ldg(c1f + static_cast<size_t>(kk) * C + ci);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int xp = pj[j] + k - pl + kk - pl;
              if (xp >= 0 && xp < m) h[j] = fmaf(__ldg(qb + xo[j] + xp), cv, h[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pos = pj[j] + k - pl;
          ra[j] = (ci < C && pos >= 0 && pos < m) ? fmaxf(h[j], 0.f) : 0.f;
        }
        // B: c2[f, k, ci, o0 + st_c .. + 4]
        const int o = o0 + st_c;
        if (ci < C) {
          const float* src = c2f + (static_cast<size_t>(k) * C + ci) * C + o;
          if (a.vec && o < C) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(src));
            rb[0] = t.x;
            rb[1] = t.y;
            rb[2] = t.z;
            rb[3] = t.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) rb[j] = o + j < C ? __ldg(src + j) : 0.f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) rb[j] = 0.f;
        }
      };
      auto store = [&](int buf) {
        *reinterpret_cast<float4*>(&As[buf][st_k][st_c]) =
            make_float4(ra[0], ra[1], ra[2], ra[3]);
        *reinterpret_cast<float4*>(&Bs[buf][st_k][st_c]) =
            make_float4(rb[0], rb[1], rb[2], rb[3]);
      };

      load(0);
      store(0);
      __syncthreads();
      for (int s = 0; s < S; ++s) {
        const int buf = s & 1;
        if (s + 1 < S) load(s + 1);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (s + 1 < S) store(buf ^ 1);
        __syncthreads();
      }

      // epilogue: relu(h2) . w over this thread's channels, row by row
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        wv[j] = o < C ? __ldg(wf + o) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum = fmaf(fmaxf(acc[i][j], 0.f), wv[j], sum);
        red[tx][i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4] = sum;
      }
      __syncthreads();
      if (tid < BM) {
        float t = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) t += red[u][tid];
        rowacc[tid] = o0 == 0 ? t : rowacc[tid] + t;
      }
      __syncthreads();
    }
    // each query adds its rows of this tile in increasing position
    if (tid < nq) {
      const int lo = max(r0, tid * m), hi = min(r0 + BM, (tid + 1) * m);
      float t = zacc[tid];
      for (int r = lo; r < hi; ++r) t += rowacc[r - r0];
      zacc[tid] = t;
    }
    __syncthreads();
  }
  if (tid < nq) {
    const float z = zacc[tid] / static_cast<float>(m) + a.b[f];
    a.out[static_cast<size_t>(f) * a.Q + q0 + tid] =
        z * a.y_std[f] + a.y_mean[f];
  }
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
  const int qt = m >= BM ? 1 : BM / m;
  const int tiles = (Q + qt - 1) / qt;
  const long long blocks = static_cast<long long>(F) * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
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
               qt,
               tiles,
               C % 4 == 0 && reinterpret_cast<uintptr_t>(c2) % 16 == 0};
  cnn_filter_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
