// Tiled pairwise Euclidean distances for Hopper (sm_90a), float32 on the
// CUDA cores (no TF32: the build's training targets and the search's prune
// decisions compare these values, and the reference accumulates in f32).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/l2_scan/kernel.py  pairwise_l2_kernel  (Q,m)x(B,m)->(Q,B)
//   * src/repro/kernels/l2_scan/kernel.py  slab_l2_kernel      (F,Nq,m)x(F,R,m)->(F,Nq,R)
// Both compute d = sqrt(max(|q|^2 + |s|^2 - 2 q.s, 0)).  The TPU kernels carry
// the q.s sum across an "arbitrary" grid axis in the output block; blocks on a
// GPU run in no order, so here each block owns one 64x64 output tile and loops
// over m itself.  The squared norms are accumulated from the same shared-memory
// tiles the dot products read, so q and s are each read once per tile.  The
// slab form adds the slab index as grid dimension z (strides per slab).
//
// Bound on an H100: 2*Q*B*m operations against (Q*m + B*m + Q*B)*4 bytes.
// At the build's shapes (Q=600 global queries, B = a chunk of leaf rows,
// m=256) that is ~300 operations per byte, so the f32 CUDA-core rate
// (67 TFLOP/s) bounds it.  This first kernel is a plain register-tiled SGEMM
// (4x4 outputs per thread, 16-deep shared-memory stages, no async copies);
// wgmma cannot be used without giving up full f32, and TMA / pipelining are
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // series rows per block
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
l2_tile_kernel(const float* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, int nq, int ns, int m,
               long long q_stride, long long s_stride, long long o_stride) {
  const long long b = blockIdx.z;
  q += b * q_stride;
  s += b * s_stride;
  out += b * o_stride;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  __shared__ float As[BK][BM + 4];   // q tile, transposed: As[k][row]
  __shared__ float Bs[BK][BN + 4];   // s tile, transposed: Bs[k][row]
  __shared__ float qn[BM];
  __shared__ float sn[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;           // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;           // output rows    ty*4 .. ty*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;                  // threads 0..63: |q_row|^2, 64..127: |s_row|^2

  for (int k0 = 0; k0 < m; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < nq && gk < m) ? q[(long long)gr * m + gk] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = col0 + r, gk = k0 + kk;
      Bs[kk][r] = (gr < ns && gk < m) ? s[(long long)gr * m + gk] : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) norm = fmaf(As[kk][tid], As[kk][tid], norm);
    } else if (tid < BM + BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        norm = fmaf(Bs[kk][tid - BM], Bs[kk][tid - BM], norm);
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) qn[tid] = norm;
  else if (tid < BM + BN) sn[tid - BM] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= ns) continue;
      const float d2 = qn[ty * 4 + i] + sn[tx * 4 + j] - 2.f * acc[i][j];
      out[(long long)r * ns + c] = sqrtf(fmaxf(d2, 0.f));
    }
  }
}

int launch(const float* q, const float* s, float* out, int batch, int nq,
           int ns, int m, long long q_stride, long long s_stride,
           long long o_stride, cudaStream_t stream) {
  if (batch <= 0 || nq <= 0 || ns <= 0) return cudaGetLastError();
  dim3 grid((ns + BN - 1) / BN, (nq + BM - 1) / BM, batch);
  l2_tile_kernel<<<grid, THREADS, 0, stream>>>(q, s, out, nq, ns, m, q_stride,
                                               s_stride, o_stride);
  return cudaGetLastError();
}

}  // namespace

// queries (Q, m), series (B, m) -> out (Q, B); all contiguous float32.
extern "C" int pairwise_l2(const void* queries, const void* series, void* out,
                           int Q, int B, int m, void* stream) {
  return launch(static_cast<const float*>(queries),
                static_cast<const float*>(series), static_cast<float*>(out),
                1, Q, B, m, 0, 0, 0, static_cast<cudaStream_t>(stream));
}

// queries (F, Nq, m), slabs (F, R, m) -> out (F, Nq, R); F <= 65535.
extern "C" int slab_l2(const void* queries, const void* slabs, void* out,
                       int F, int Nq, int R, int m, void* stream) {
  return launch(static_cast<const float*>(queries),
                static_cast<const float*>(slabs), static_cast<float*>(out), F,
                Nq, R, m, (long long)Nq * m, (long long)R * m,
                (long long)Nq * R, static_cast<cudaStream_t>(stream));
}
