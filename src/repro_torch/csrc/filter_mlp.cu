// Filter-MLP inference for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/filter_mlp/kernel.py:
//
// * fused_filter_mlp_kernel (_fused_body for float32 and bfloat16 weights,
//   _fused_body_q for int8), which evaluates, for every (filter f, query q),
//     z   = relu(q . w1[f] + b1[f]) . w2[f] + b2[f]
//     out = z * y_std[f] + y_mean[f] - offset[f]        (this op order)
//   and writes the search-ready (F, Q) d_F block in one launch.  C entries
//   fused_filter_mlp, fused_filter_mlp_bf16, fused_filter_mlp_int8.
// * filter_mlp_kernel (body _mlp_kernel), the per-filter sweep that the
//   filter-inference benchmark measures the fused kernel against: the raw z
//   alone, float32 weights only, no statistics and no offsets.  C entry
//   filter_mlp: the fused float32 entry's two designs below, with the raw
//   epilogue (z = relu(q . w1 + b1) . w2 + b2) chosen by their RAW template
//   parameter.
//
// Every sum is float32 (the conformal offsets are calibrated on these
// values and the prune decisions compare them with lower bounds).  int8
// keeps the TPU kernel's algebra: the per-filter scale s1[f] multiplies the
// layer-1 sum before + b1, and the w2 row is used as w2 * s2[f].  The
// weights are read at their payload width (m*h per filter at 4, 2 or 1
// bytes) and upcast exactly.
//
// Bound on an H100: 2*F*Q*m*h operations against the weight stream
// F*((m*h + h)*w + (h + 3)*4) bytes at payload width w (+ queries and
// output).  At the search's batches (F ~ 4-6.5k, Q = 256, m = h = 256) that
// is >= 128 operations per byte, bound by operations: 3.26 ms at F = 6488 at
// the float32 CUDA-core rate (67 TFLOP/s), 1.32 ms for three TF32 passes at
// the tensor-core rate (495 TFLOP/s), 0.88 ms for two.  At search_early's
// single query it is <= 2 operations per byte, bound by the weight bytes:
// 0.32 / 0.16 / 0.08 ms at F = 4096 for float32 / bf16 / int8.
//
// The fused entries take one of two designs by Q: the stream design up to
// kStreamMaxQ = 12 queries (three passes over w1), the tile design above.
// On an H100 at F = 6488, m = h = 256 the stream design is never the slower
// up to Q = 12 for any payload (16 for int8), the tile design is the faster
// from Q = 14 for float32 and bf16 (bench/fused_designs.py times both;
// PERF.md).  search_early sends Q = 1, the batches and calibration more
// than 64, so the limit only has to fall between them:
//
// * Tile (mlp_tile_kernel, the batches, calibration, grouped search and the
//   suite).  The TPU kernel groups 8 filters into one (m, 8h) MXU operand and
//   sums each filter's lanes with a block-diagonal matmul; a block here has
//   227 KB of shared memory, so it owns one filter and a 128-query tile.
//   Its 8 warps walk the hidden layer in 128-lane chunks and each chunk's m
//   in 32-deep stages through a ring of 3 cp.async stages (the query tile in
//   float32, the w1 tile at payload width, upcast as fragments are loaded).
//   The layer-1 products run on the tensor cores as split-TF32 mma.sync
//   (tf32x3.cuh): three products for float32 weights, two for bf16 and int8,
//   which are exact in TF32, all into one accumulator (the limit leaves room
//   for the tensor cores' rounding: ~190 registers a thread, one block an
//   SM).  The epilogue stays in registers, in the TPU kernel's op order:
//   x s1 (int8), + b1, relu, x w2 (x s2 for int8), summed over a warp's
//   lanes through quad shuffles and across warps through shared memory;
//   then + b2, * y_std + y_mean - offset.  No hidden
//   activation reaches device memory; the query tiles of one filter are
//   adjacent in the grid, so its weights come from device memory once.
// * Stream (mlp_stream_kernel, search_early's Q = 1).  A tile would compute
//   128 queries' products for one.  Here a block per filter keeps up to 4
//   queries in shared memory and streams w1[f] once per 4 queries with
//   16-byte loads at payload width: thread (column c, slice r) accumulates
//   the 4, 8 or 16 hidden lanes of its 16 bytes over rows r, r + S, ... with
//   float32 FMAs; the slices are summed through warp shuffles and shared
//   memory, then the same epilogue.
//
// filter_mlp takes the float32 instances of both designs by the same Q
// limit, three tensor-core passes in the tile design; only the epilogue
// differs (RAW: + b2, no statistics, no offsets).  Ragged F, Q, m and h are
// zero-filled or masked in every kernel, so nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

__device__ __forceinline__ float upcast(float w) { return w; }
__device__ __forceinline__ float upcast(__nv_bfloat16 w) {
  return __bfloat162float(w);
}
__device__ __forceinline__ float upcast(int8_t w) {
  return static_cast<float>(w);
}

// a query's summed z: raw (filter_mlp) or de-standardised minus the offset
template <bool RAW>
__device__ __forceinline__ float epilogue(float z, int f,
                                          const float* __restrict__ b2,
                                          const float* __restrict__ ym,
                                          const float* __restrict__ ys,
                                          const float* __restrict__ off) {
  if constexpr (RAW)
    return z + b2[f];
  else
    return (z + b2[f]) * ys[f] + ym[f] - off[f];
}

// ---- tile design: split-TF32 tensor cores --------------------------------

constexpr int M_WARPS_M = 2;            // warps along the queries
constexpr int M_WARPS_N = 4;            // warps along the hidden lanes
constexpr int M_MI = 4;                 // m16 query tiles per warp
constexpr int M_NI = 4;                 // n8 lane tiles per warp
constexpr int MQ = M_WARPS_M * 16 * M_MI;   // queries per block
constexpr int MH = M_WARPS_N * 8 * M_NI;    // hidden lanes per chunk
constexpr int MK = 32;                  // stage depth over m
constexpr int QLD = MK + 4;             // staged query row stride (words)
constexpr int M_STAGES = 3;
constexpr int M_THREADS = 32 * M_WARPS_M * M_WARPS_N;

template <typename T>
struct TileShape {
  // staged w1 row: 128 lanes + 32 bytes, so the 4 k-rows a fragment load
  // touches start 8 banks apart (no bank conflicts at any payload width)
  static constexpr int WLD = MH + 32 / sizeof(T);
  static constexpr int Q_BYTES = MQ * QLD * sizeof(float);
  static constexpr int STAGE_BYTES = Q_BYTES + MK * WLD * sizeof(T);
  static constexpr int SMEM = M_STAGES * STAGE_BYTES;  // 105 / 81 / 69 KB
};

// RAW: the raw z + b2 (filter_mlp); else (z + b2) * y_std + y_mean - offset
template <typename T, bool RAW>
__global__ void __launch_bounds__(M_THREADS, 1)
mlp_tile_kernel(const float* __restrict__ q, const T* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2, const float* __restrict__ ym,
                const float* __restrict__ ys, const float* __restrict__ off,
                float* __restrict__ out, int Q, int m, int h, int q_tiles,
                int vec) {
  using S = TileShape<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[M_WARPS_N][MQ];

  const int f = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * MQ;
  const T* W1 = w1 + (long long)f * m * h;
  const float* B1 = b1 + (long long)f * h;
  const T* W2 = w2 + (long long)f * h;
  float scale1 = 1.f, scale2 = 1.f;
  if constexpr (kScaled) {
    scale1 = s1[f];
    scale2 = s2[f];
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / M_WARPS_N;      // queries     wm*16*M_MI ..
  const int wn = warp % M_WARPS_N;      // chunk lanes wn*8*M_NI ..
  const int nk = (m + MK - 1) / MK;
  const int steps = nk * ((h + MH - 1) / MH);   // (chunk, k stage) pairs

  auto q_stage = [&](int st) {
    return reinterpret_cast<float*>(smem + st * S::STAGE_BYTES);
  };
  auto w_stage = [&](int st) {
    return reinterpret_cast<T*>(smem + st * S::STAGE_BYTES + S::Q_BYTES);
  };
  auto load = [&](int step) {
    const int st = step % M_STAGES;
    const int k0 = step % nk * MK, h0 = step / nk * MH;
    tf32x3::stage_tile<float, MQ, MK, QLD, M_THREADS>(q_stage(st), q, q0, Q,
                                                       k0, m, vec, tid);
    tf32x3::stage_tile<T, MK, MH, S::WLD, M_THREADS>(w_stage(st), W1, k0, m,
                                                      h0, h, vec, tid);
  };

  float acc[M_MI][M_NI][4];
#pragma unroll
  for (int i = 0; i < M_MI; ++i)
#pragma unroll
    for (int j = 0; j < M_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float z[M_MI][2] = {};                // rows wm*16*M_MI + i*16 + g (+ 8)

  tf32x3::cp_async_ring<M_STAGES>(steps, load, [&](int step) {
    tf32x3::warp_stage<M_MI, M_NI, MK, QLD, S::WLD, kF32>(
        acc, q_stage(step % M_STAGES) + wm * 16 * M_MI * QLD,
        w_stage(step % M_STAGES) + wn * 8 * M_NI, g, t,
        [](T w) { return upcast(w); });
    if (step % nk == nk - 1) {          // the chunk's hidden lanes are done
      const int h0 = step / nk * MH;
#pragma unroll
      for (int j = 0; j < M_NI; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ln = h0 + wn * 8 * M_NI + j * 8 + 2 * t + c;
          if (ln >= h) continue;
          const float bj = B1[ln];
          const float wj = upcast(W2[ln]) * scale2;
#pragma unroll
          for (int i = 0; i < M_MI; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float v = acc[i][j][2 * half + c];
              if constexpr (kScaled) v *= scale1;
              z[i][half] = fmaf(fmaxf(v + bj, 0.f), wj, z[i][half]);
            }
        }
#pragma unroll
      for (int i = 0; i < M_MI; ++i)
#pragma unroll
        for (int j = 0; j < M_NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  });

  // the 4 threads of a quad hold one query row's lanes 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < M_MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      z[i][half] += __shfl_xor_sync(0xffffffffu, z[i][half], 1);
      z[i][half] += __shfl_xor_sync(0xffffffffu, z[i][half], 2);
      if (t == 0) red[wn][wm * 16 * M_MI + i * 16 + g + half * 8] = z[i][half];
    }
  __syncthreads();
  if (tid < MQ && q0 + tid < Q) {
    float zq = 0.f;
#pragma unroll
    for (int w = 0; w < M_WARPS_N; ++w) zq += red[w][tid];
    out[(long long)f * Q + q0 + tid] = epilogue<RAW>(zq, f, b2, ym, ys, off);
  }
}

// ---- stream design: few queries, w1 streamed once ------------------------

constexpr int SQ = 4;                   // queries per pass over w1[f]
constexpr int S_THREADS = 256;
constexpr int S_WARPS = S_THREADS / 32;
constexpr int MAX_PASS_LANES = 256;     // hidden lanes per pass
constexpr int S_RED = S_WARPS * MAX_PASS_LANES * SQ;   // 32 KB of partials

// the V elements of one 16-byte column of a w1 row; `valid` of them lie
// inside h (all V when vec)
template <typename T, int V>
__device__ __forceinline__ void load_column(const T* p, int valid, bool vec,
                                            T (&w)[V]) {
  if (vec) {
    *reinterpret_cast<uint4*>(w) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = v < valid ? p[v] : T();
  }
}

// cw = 2^cw_log2 16-byte columns per pass (cw * V <= 256 hidden lanes), so
// S_THREADS / cw row slices; vec: h * sizeof(T) % 16 == 0, w1 16-byte aligned
template <typename T, bool RAW>
__global__ void __launch_bounds__(S_THREADS)
mlp_stream_kernel(const float* __restrict__ q, const T* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const T* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2, const float* __restrict__ ym,
                  const float* __restrict__ ys, const float* __restrict__ off,
                  float* __restrict__ out, int Q, int m, int h, int cw_log2,
                  int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) float qs[];   // [SQ][m]
  __shared__ float red[S_RED];

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cw = 1 << cw_log2;
  const int slices = S_THREADS >> cw_log2;
  const int c = tid & (cw - 1), r = tid >> cw_log2;
  const int lanes = cw * V;
  // partial sums left after the in-warp reduction: one set per slice when a
  // slice spans whole warps, else one per warp
  const int sets = cw >= 32 ? slices : S_WARPS;
  const int set = cw >= 32 ? r : warp;
  const T* W1 = w1 + (long long)f * m * h;
  float scale1 = 1.f, scale2 = 1.f;
  if constexpr (kScaled) {
    scale1 = s1[f];
    scale2 = s2[f];
  }

  for (int q0 = 0; q0 < Q; q0 += SQ) {
    __syncthreads();                    // the last pass is done with qs, red
    for (int e = tid; e < SQ * m; e += S_THREADS) {
      const int qq = e / m;
      qs[e] = q0 + qq < Q ? q[(long long)(q0 + qq) * m + e % m] : 0.f;
    }
    __syncthreads();

    float z[SQ] = {};
    for (int l0 = 0; l0 < h; l0 += lanes) {
      float acc[V][SQ] = {};
      const int ln0 = l0 + c * V;
      if (ln0 < h) {
        const T* p = W1 + ln0;
#pragma unroll 4
        for (int k = r; k < m; k += slices) {
          alignas(16) T w[V];
          load_column<T, V>(p + (long long)k * h, h - ln0, vec, w);
          float x[SQ];
#pragma unroll
          for (int qq = 0; qq < SQ; ++qq) x[qq] = qs[qq * m + k];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float wv = upcast(w[v]);
#pragma unroll
            for (int qq = 0; qq < SQ; ++qq)
              acc[v][qq] = fmaf(x[qq], wv, acc[v][qq]);
          }
        }
      }
      for (int o = cw; o < 32; o <<= 1)  // slices that share a warp
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int qq = 0; qq < SQ; ++qq)
            acc[v][qq] += __shfl_xor_sync(0xffffffffu, acc[v][qq], o);
      if (cw >= 32 || lane < cw) {
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int qq = 0; qq < SQ; ++qq)
            red[(set * SQ + qq) * lanes + c * V + v] = acc[v][qq];
      }
      __syncthreads();
      if (tid < lanes && l0 + tid < h) {
        const int ln = l0 + tid;
        const float bj = b1[(long long)f * h + ln];
        const float wj = upcast(w2[(long long)f * h + ln]) * scale2;
#pragma unroll
        for (int qq = 0; qq < SQ; ++qq) {
          float pre = 0.f;
          for (int s = 0; s < sets; ++s) pre += red[(s * SQ + qq) * lanes + tid];
          if constexpr (kScaled) pre *= scale1;
          z[qq] = fmaf(fmaxf(pre + bj, 0.f), wj, z[qq]);
        }
      }
      __syncthreads();                  // red is free again
    }

#pragma unroll
    for (int qq = 0; qq < SQ; ++qq) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        z[qq] += __shfl_xor_sync(0xffffffffu, z[qq], o);
      if (lane == 0) red[warp * SQ + qq] = z[qq];
    }
    __syncthreads();
    if (tid < SQ && q0 + tid < Q) {
      float zq = 0.f;
      for (int w = 0; w < S_WARPS; ++w) zq += red[w * SQ + tid];
      out[(long long)f * Q + q0 + tid] = epilogue<RAW>(zq, f, b2, ym, ys, off);
    }
  }
}

// the largest Q that takes the stream design; the default is the measured
// crossover, and bench/fused_designs.py builds scratch copies of this file
// with 0 (every Q tiled) and a large value (every Q streamed) to time both
#ifndef FILTER_MLP_STREAM_MAX_Q
#define FILTER_MLP_STREAM_MAX_Q 12
#endif
constexpr int kStreamMaxQ = FILTER_MLP_STREAM_MAX_Q;

template <typename T, bool RAW>
int launch_fused(const void* queries, const void* w1, const void* s1,
                 const void* b1, const void* w2, const void* s2,
                 const void* b2, const void* y_mean, const void* y_std,
                 const void* offsets, void* out, int F, int Q, int m, int h,
                 void* stream) {
  if (F <= 0 || Q <= 0) return cudaGetLastError();
  constexpr int V = 16 / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(queries);
  const auto* w1p = static_cast<const T*>(w1);
  const auto* s1p = static_cast<const float*>(s1);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* w2p = static_cast<const T*>(w2);
  const auto* s2p = static_cast<const float*>(s2);
  const auto* b2p = static_cast<const float*>(b2);
  const auto* ymp = static_cast<const float*>(y_mean);
  const auto* ysp = static_cast<const float*>(y_std);
  const auto* offp = static_cast<const float*>(offsets);
  auto* outp = static_cast<float*>(out);
  cudaError_t err;
  if (Q <= kStreamMaxQ) {
    const int columns = (h + V - 1) / V;
    int cw_log2 = 0;
    while ((1 << cw_log2) < columns && (2 << cw_log2) * V <= MAX_PASS_LANES)
      ++cw_log2;
    const int vec = h % V == 0 && tf32x3::aligned16(w1);
    const int smem = SQ * m * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(mlp_stream_kernel<T, RAW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    mlp_stream_kernel<T, RAW><<<F, S_THREADS, smem, st>>>(
        qp, w1p, s1p, b1p, w2p, s2p, b2p, ymp, ysp, offp, outp, Q, m, h,
        cw_log2, vec);
  } else {
    const int q_tiles = (Q + MQ - 1) / MQ;
    const long long blocks = (long long)F * q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const int vec = m % 4 == 0 && h % V == 0 && tf32x3::aligned16(queries) &&
                    tf32x3::aligned16(w1);
    err = cudaFuncSetAttribute(mlp_tile_kernel<T, RAW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TileShape<T>::SMEM);
    if (err != cudaSuccess) return err;
    mlp_tile_kernel<T, RAW><<<(unsigned)blocks, M_THREADS,
                              TileShape<T>::SMEM, st>>>(
        qp, w1p, s1p, b1p, w2p, s2p, b2p, ymp, ysp, offp, outp, Q, m, h,
        q_tiles, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// queries (Q, m); w1 (F, m, h); b1, w2 (F, h); b2, y_mean, y_std, offsets
// (F,) -> out (F, Q); all contiguous; w1/w2 float32, bfloat16 or int8 (the
// int8 entry also takes the (F,) float32 scales s1, s2), the rest float32.
extern "C" int fused_filter_mlp(const void* queries, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* y_mean, const void* y_std,
                                const void* offsets, void* out, int F, int Q,
                                int m, int h, void* stream) {
  return launch_fused<float, false>(queries, w1, nullptr, b1, w2, nullptr,
                                    b2, y_mean, y_std, offsets, out, F, Q, m,
                                    h, stream);
}

extern "C" int fused_filter_mlp_bf16(const void* queries, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* y_mean,
                                     const void* y_std, const void* offsets,
                                     void* out, int F, int Q, int m, int h,
                                     void* stream) {
  return launch_fused<__nv_bfloat16, false>(queries, w1, nullptr, b1, w2,
                                            nullptr, b2, y_mean, y_std,
                                            offsets, out, F, Q, m, h, stream);
}

extern "C" int fused_filter_mlp_int8(const void* queries, const void* w1,
                                     const void* s1, const void* b1,
                                     const void* w2, const void* s2,
                                     const void* b2, const void* y_mean,
                                     const void* y_std, const void* offsets,
                                     void* out, int F, int Q, int m, int h,
                                     void* stream) {
  return launch_fused<int8_t, false>(queries, w1, s1, b1, w2, s2, b2, y_mean,
                                     y_std, offsets, out, F, Q, m, h, stream);
}

// queries (Q, m); w1 (F, m, h); b1, w2 (F, h); b2 (F,) -> out (F, Q), the raw
// relu(q . w1 + b1) . w2 + b2; all contiguous float32.
extern "C" int filter_mlp(const void* queries, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int F,
                          int Q, int m, int h, void* stream) {
  return launch_fused<float, true>(queries, w1, nullptr, b1, w2, nullptr, b2,
                                   nullptr, nullptr, nullptr, out, F, Q, m, h,
                                   stream);
}

