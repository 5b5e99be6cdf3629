// Filter-MLP inference for Hopper (sm_90a), float32 on the CUDA cores.
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
//   filter_mlp.
//
// One kernel, templated on the weight payload (float, __nv_bfloat16 or
// int8_t) and on the epilogue (raw z, or de-standardized minus the offset).
// Each w1/w2 element is read at its payload width and upcast to f32
// as it lands in shared memory (w1) or registers (w2); every product and sum
// stays f32 (no bf16/TF32 tensor-core MMA: the prune decisions compare these
// values with lower bounds).  int8 keeps the TPU kernel's algebra: the
// per-filter scale s1[f] multiplies the layer-1 sum before + b1, and the w2
// row is used as w2 * s2[f].  Only the weight bytes change with the payload
// (m*h per filter at 4, 2 or 1 bytes); the arithmetic is the same.
//
// The TPU's fused kernel groups bf filters into one (m, bf*h) operand block
// (2 MB at m = h = 256, bf = 8) and sums each filter's h lanes with a matmul
// against a block-diagonal 0/1 operand, both devices of the 128x128 MXU and
// its large VMEM; its per-filter kernel takes one filter per grid step and
// re-streams the query tile for every filter.  A block here has at most
// 227 KB of shared memory, so both entries take the per-filter layout: each
// block owns one (filter, 64-query tile), re-reads its query tile for every
// filter, loops over 64-lane chunks of the hidden layer, computes each
// chunk's (64 x 64) hidden tile as a register-tiled product over m (16-deep
// shared-memory stages), applies b1/relu/w2 in registers and keeps each
// query's layer-2 partial sum in a register.  The 16 threads that share a
// query row then reduce their partials with warp shuffles, and the epilogue
// applies b2 (and, fused, de-standardization and the offset).  No hidden
// activation ever reaches device memory.  Ragged F, Q, m and h are masked in
// the kernel, so nothing is padded.
//
// Bound on an H100: 2*F*Q*m*h operations against the weight stream
// F*((m*h + h)*w + (h + 3)*4) bytes at payload width w = 4, 2 or 1 (+ queries
// and output).  At the search's shapes (F ~ 4k filters, Q = 256, m = h = 256)
// that is >= 128 operations per byte, and at the benchmark's largest shape
// (F = 4096, Q = 128, m = h = 128) >= 64, so the f32 CUDA-core rate
// (67 TFLOP/s) bounds every variant and both entries.  The query tiles of one
// filter are adjacent in the grid, so a filter's weights come from device
// memory once and from L2 for its other tiles.  No TF32: the conformal
// offsets are calibrated on these values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float upcast(float w) { return w; }
__device__ __forceinline__ float upcast(__nv_bfloat16 w) {
  return __bfloat162float(w);
}
__device__ __forceinline__ float upcast(int8_t w) {
  return static_cast<float>(w);
}

constexpr int BQ = 64;   // queries per block
constexpr int HC = 64;   // hidden lanes per chunk
constexpr int BK = 16;   // depth of one shared-memory stage over m
constexpr int THREADS = 256;

// s1, s2: per-filter int8 scales (read only when T is int8_t); ym, ys, off:
// the fused epilogue's statistics and offsets (read only when kDestd)
template <typename T, bool kDestd>
__global__ void __launch_bounds__(THREADS)
mlp_kernel(const float* __restrict__ q, const T* __restrict__ w1,
           const float* __restrict__ s1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ s2,
           const float* __restrict__ b2, const float* __restrict__ ym,
           const float* __restrict__ ys, const float* __restrict__ off,
           float* __restrict__ out, int Q, int m, int h, int q_tiles) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  const int f = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const T* W1 = w1 + (long long)f * m * h;
  const float* B1 = b1 + (long long)f * h;
  const T* W2 = w2 + (long long)f * h;
  float scale1 = 1.f, scale2 = 1.f;
  if constexpr (kScaled) {
    scale1 = s1[f];
    scale2 = s2[f];
  }

  __shared__ float As[BK][BQ + 4];   // query tile, transposed: As[k][query]
  __shared__ float Ws[BK][HC + 4];   // w1 tile: Ws[k][lane]

  const int tid = threadIdx.x;
  const int tx = tid % 16;           // hidden lanes tx*4 .. tx*4+3 of a chunk
  const int ty = tid / 16;           // queries      ty*4 .. ty*4+3

  float z[4] = {0.f, 0.f, 0.f, 0.f};

  for (int h0 = 0; h0 < h; h0 += HC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < m; k0 += BK) {
#pragma unroll
      for (int e = tid; e < BQ * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gq = q0 + r, gk = k0 + kk;
        As[kk][r] = (gq < Q && gk < m) ? q[(long long)gq * m + gk] : 0.f;
      }
#pragma unroll
      for (int e = tid; e < BK * HC; e += THREADS) {
        const int kk = e / HC, c = e % HC;
        const int gk = k0 + kk, gl = h0 + c;
        Ws[kk][c] =
            (gk < m && gl < h) ? upcast(W1[(long long)gk * h + gl]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lane = h0 + tx * 4 + j;
      if (lane >= h) continue;
      const float bj = B1[lane];
      float wj = upcast(W2[lane]);
      if constexpr (kScaled) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] *= scale1;
        wj *= scale2;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = fmaf(fmaxf(acc[i][j] + bj, 0.f), wj, z[i]);
    }
  }

  // the 16 threads of one query row are 16 consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) z[i] += __shfl_xor_sync(0xffffffffu, z[i], o);

  if (tx == 0) {
    const float bias = b2[f];
    if constexpr (kDestd) {
      const float mean = ym[f], sd = ys[f], o = off[f];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r < Q) out[(long long)f * Q + r] = (z[i] + bias) * sd + mean - o;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r < Q) out[(long long)f * Q + r] = z[i] + bias;
      }
    }
  }
}

template <typename T, bool kDestd = true>
int launch(const void* queries, const void* w1, const void* s1,
           const void* b1, const void* w2, const void* s2, const void* b2,
           const void* y_mean, const void* y_std, const void* offsets,
           void* out, int F, int Q, int m, int h, void* stream) {
  if (F <= 0 || Q <= 0) return cudaGetLastError();
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)F * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mlp_kernel<T, kDestd><<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const T*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const float*>(y_mean),
      static_cast<const float*>(y_std), static_cast<const float*>(offsets),
      static_cast<float*>(out), Q, m, h, q_tiles);
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
  return launch<float>(queries, w1, nullptr, b1, w2, nullptr, b2, y_mean,
                       y_std, offsets, out, F, Q, m, h, stream);
}

extern "C" int fused_filter_mlp_bf16(const void* queries, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* y_mean,
                                     const void* y_std, const void* offsets,
                                     void* out, int F, int Q, int m, int h,
                                     void* stream) {
  return launch<__nv_bfloat16>(queries, w1, nullptr, b1, w2, nullptr, b2,
                               y_mean, y_std, offsets, out, F, Q, m, h,
                               stream);
}

extern "C" int fused_filter_mlp_int8(const void* queries, const void* w1,
                                     const void* s1, const void* b1,
                                     const void* w2, const void* s2,
                                     const void* b2, const void* y_mean,
                                     const void* y_std, const void* offsets,
                                     void* out, int F, int Q, int m, int h,
                                     void* stream) {
  return launch<int8_t>(queries, w1, s1, b1, w2, s2, b2, y_mean, y_std,
                        offsets, out, F, Q, m, h, stream);
}

// queries (Q, m); w1 (F, m, h); b1, w2 (F, h); b2 (F,) -> out (F, Q), the raw
// relu(q . w1 + b1) . w2 + b2; all contiguous float32.
extern "C" int filter_mlp(const void* queries, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int F,
                          int Q, int m, int h, void* stream) {
  return launch<float, false>(queries, w1, nullptr, b1, w2, nullptr, b2,
                              nullptr, nullptr, nullptr, out, F, Q, m, h,
                              stream);
}
