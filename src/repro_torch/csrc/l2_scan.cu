// Pairwise and slab Euclidean distances for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/l2_scan/kernel.py:
//   * pairwise_l2_kernel  (Q, m) x (B, m) -> (Q, B)
//   * slab_l2_kernel      (F, Nq, m) x (F, R, m) -> (F, Nq, R)
// Both compute d = sqrt(max(|q|^2 + |s|^2 - 2 q.s, 0)).  The TPU kernels carry
// the q.s sum across an "arbitrary" grid axis in the output block; blocks on a
// GPU run in no order, so here each block owns one output tile and loops over
// m itself.  The squared norms are accumulated in float32 from the same
// shared-memory tiles the dot products read, so q and s are each read once
// per tile.
//
// Bound on an H100: 2*Q*B*m operations against (Q*m + B*m + Q*B)*4 bytes.
// At the build's shapes (Q = 600 global queries, B = 65,536 leaf rows,
// m = 256) that is ~300 operations per byte: bound by operations, 0.30 ms at
// the float32 CUDA-core rate (67 TFLOP/s), 0.12 ms for the three TF32
// passes at the tensor-core rate (495 TFLOP/s).
//
// pairwise_l2 (l2_tf32x3_kernel): the dot products run on the tensor cores
// as split-TF32 mma.sync (tf32x3.cuh: three products per float32 pair),
// which keeps float32 accuracy (a one-pass TF32 product would not: the
// build's training targets and the search's prune decisions compare these
// values).  Each 32-deep stage is summed on the tensor cores and added into
// float32 registers on the CUDA cores, which keeps the tensor cores'
// rounding toward zero to an eighth of the sum.  A block of 8 warps owns a
// 128 x 128 output tile (warp tile 64 x 32, 16 m16n8k8 tiles) and walks m in
// 32-deep stages through a ring of 3 cp.async stages in dynamic shared
// memory (108 KB), so two stages' loads are in flight while one is
// computed.  Rows are padded to 36 words, which makes both the fragment
// loads and the norms' float4 reads free of bank conflicts.  The epilogue
// stages the distances in shared memory and writes whole 512-byte row
// segments.  At the build's shape that is 512 x 5 blocks, the last row tile
// ragged (600 = 4 x 128 + 88); ragged edges are zero-filled by cp.async and
// masked on store, nothing is padded in device memory.  The two running
// sums take 128 registers a thread (~220 in all), so one block fits an SM.

// slab_l2 (l2_tile_kernel) is still the first port's plain register-tiled
// loop on the CUDA cores (64 x 64 tile, 4 x 4 outputs per thread, 16-deep
// synchronous stages), the slab index as grid dimension z; it is the next
// kernel to take the tensor-core body.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

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


// ---- pairwise_l2: split-TF32 tensor cores --------------------------------

constexpr int WARPS_M = 2;              // warps along the query rows
constexpr int WARPS_N = 4;              // warps along the series rows
constexpr int MI = 4;                   // m16 row tiles per warp
constexpr int NI = 4;                   // n8 column tiles per warp
constexpr int TM = WARPS_M * 16 * MI;   // query rows per block
constexpr int TN = WARPS_N * 8 * NI;    // series rows per block
constexpr int TK = 32;                  // depth of one stage
constexpr int TLD = TK + 4;             // staged row stride (words)
constexpr int STAGES = 3;
constexpr int TC_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int STAGE_FLOATS = (TM + TN) * TLD;
constexpr int OLD = TN + 4;             // row stride of the staged output
constexpr int TC_SMEM = STAGES * STAGE_FLOATS * sizeof(float);   // 108 KB
static_assert(TM * OLD <= STAGES * STAGE_FLOATS, "output tile fits the ring");
static_assert(TM + TN <= TC_THREADS, "a thread per norm");

__global__ void __launch_bounds__(TC_THREADS, 1)
l2_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int nq, int ns, int m, int vec_in,
                 int vec_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float qn[TM];
  __shared__ float sn[TN];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N;        // rows    wm*16*MI ..
  const int wn = warp % WARPS_N;        // columns wn*8*NI ..
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int nk = (m + TK - 1) / TK;

  // each stage's products are summed on the tensor cores (`part`), the
  // stage sums on the CUDA cores (`dot`), see tf32x3.cuh
  float dot[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dot[i][j][e] = 0.f;
  float norm = 0.f;   // threads 0..TM-1: |q_row|^2, then TN |s_row|^2

  auto load = [&](int stage, int k_stage) {
    float* a = smem + stage * STAGE_FLOATS;
    tf32x3::stage_tile<float, TM, TK, TLD, TC_THREADS>(
        a, q, row0, nq, k_stage * TK, m, vec_in, tid);
    tf32x3::stage_tile<float, TN, TK, TLD, TC_THREADS>(
        a + TM * TLD, s, col0, ns, k_stage * TK, m, vec_in, tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    tf32x3::cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();                    // stage `it` landed; `it - 1` is free
    if (it + STAGES - 1 < nk) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    tf32x3::cp_async_commit();

    const float* As = smem + (it % STAGES) * STAGE_FLOATS;
    const float* Bs = As + TM * TLD;
    if (tid < TM + TN) {
      const float* row = tid < TM ? As + tid * TLD : Bs + (tid - TM) * TLD;
#pragma unroll
      for (int c = 0; c < TK; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + c);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* b = Bs + (wn * 8 * NI + j * 8 + g) * TLD + kk + t;
        tf32x3::split(b[0], bh[j][0], bl[j][0]);
        tf32x3::split(b[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* a = As + (wm * 16 * MI + i * 16 + g) * TLD + kk + t;
        uint32_t ah[4], al[4];
        tf32x3::split(a[0], ah[0], al[0]);
        tf32x3::split(a[8 * TLD], ah[1], al[1]);
        tf32x3::split(a[4], ah[2], al[2]);
        tf32x3::split(a[8 * TLD + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NI; ++j)
          tf32x3::mma3(part[i][j], ah, al, bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[i][j][e] += part[i][j][e];
  }
  tf32x3::cp_async_wait<0>();

  if (tid < TM) qn[tid] = norm;
  else if (tid < TM + TN) sn[tid - TM] = norm;
  __syncthreads();                      // norms written, the ring is free

  float* tile = smem;                   // [TM][OLD] distances
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 * MI + i * 16 + g + half * 8;
        const int c = wn * 8 * NI + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(tile + r * OLD + c) = make_float2(
            sqrtf(fmaxf(qn[r] + sn[c] - 2.f * dot[i][j][2 * half], 0.f)),
            sqrtf(fmaxf(qn[r] + sn[c + 1] - 2.f * dot[i][j][2 * half + 1],
                        0.f)));
      }
  __syncthreads();

  if (vec_out) {                        // ns % 4 == 0: whole float4s
    for (int e = tid; e < TM * TN / 4; e += TC_THREADS) {
      const int r = e / (TN / 4), c = (e % (TN / 4)) * 4;
      if (row0 + r < nq && col0 + c < ns)
        *reinterpret_cast<float4*>(out + (long long)(row0 + r) * ns + col0 +
                                   c) =
            *reinterpret_cast<const float4*>(tile + r * OLD + c);
    }
  } else {
    for (int e = tid; e < TM * TN; e += TC_THREADS) {
      const int r = e / TN, c = e % TN;
      if (row0 + r < nq && col0 + c < ns)
        out[(long long)(row0 + r) * ns + col0 + c] = tile[r * OLD + c];
    }
  }
}

int launch_pairwise(const float* q, const float* s, float* out, int nq,
                    int ns, int m, cudaStream_t stream) {
  if (nq <= 0 || ns <= 0) return cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      l2_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return err;
  const int vec_in =
      m % 4 == 0 && tf32x3::aligned16(q) && tf32x3::aligned16(s);
  const int vec_out = ns % 4 == 0 && tf32x3::aligned16(out);
  dim3 grid((ns + TN - 1) / TN, (nq + TM - 1) / TM);
  l2_tf32x3_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(q, s, out, nq, ns,
                                                          m, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// queries (Q, m), series (B, m) -> out (Q, B); all contiguous float32.
extern "C" int pairwise_l2(const void* queries, const void* series, void* out,
                           int Q, int B, int m, void* stream) {
  return launch_pairwise(static_cast<const float*>(queries),
                         static_cast<const float*>(series),
                         static_cast<float*>(out), Q, B, m,
                         static_cast<cudaStream_t>(stream));
}

// queries (F, Nq, m), slabs (F, R, m) -> out (F, Nq, R); F <= 65535.
extern "C" int slab_l2(const void* queries, const void* slabs, void* out,
                       int F, int Nq, int R, int m, void* stream) {
  return launch(static_cast<const float*>(queries),
                static_cast<const float*>(slabs), static_cast<float*>(out), F,
                Nq, R, m, (long long)Nq * m, (long long)R * m,
                (long long)Nq * R, static_cast<cudaStream_t>(stream));
}
