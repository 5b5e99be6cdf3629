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
// passes at the tensor-core rate (495 TFLOP/s).  The slab sweep's slabs are
// small (Nq = 200 queries against R = 256 rows of m = 256): 6.8 GFLOP and
// 172 MB for 256 slabs, so on the split route its bytes bind (0.051 ms
// against 0.041 ms of operations).
//
// Both kernels share one body (l2_tile below): the dot products run on the
// tensor cores as split-TF32 mma.sync (tf32x3.cuh: three products per
// float32 pair), which keeps float32 accuracy (a one-pass TF32 product
// would not: the build's training targets and the search's prune decisions
// compare these values).  Each 32-deep stage is summed on the tensor cores
// and added into float32 registers on the CUDA cores, which keeps the
// tensor cores' rounding toward zero to an eighth of the sum.  A block of 8
// warps walks m in 32-deep stages through a ring of 3 cp.async stages in
// dynamic shared memory (~100-108 KB), so two stages' loads are in flight
// while one is computed.  Rows are padded to 36 words, which makes both the
// fragment loads and the norms' float4 reads free of bank conflicts.  The
// epilogue stages the distances in shared memory and writes whole row
// segments.  Ragged edges are zero-filled by cp.async and masked on store;
// nothing is padded in device memory.  The two running sums take a
// register each per output of the warp tile, so one block fits an SM.
//
// pairwise_l2 (l2_tf32x3_kernel): a 128 x 128 tile (queries x series, warp
// tile 64 x 32, 16 m16n8k8 tiles).  At the build's shape that is 512 x 5
// blocks, the last row tile ragged (600 = 4 x 128 + 88).
//
// slab_l2 (slab_tf32x3_kernel): the same body batched over slabs, the slab
// index as grid dimension z, so all tiles of one slab are adjacent in
// launch order and a slab's q and s come from device memory once (the
// second read hits the 50 MB L2).  Each slab offsets q, s and out by its
// own stride; the 16-byte paths need m % 4 == 0 (every input slab and row
// then starts on 16 bytes) and R % 4 == 0 (every output row).  A slab of
// the main path holds 200 queries: a 128 x 128 tile with the queries on
// the m16 row axis computes them as 256 rows, 22% zeros.  So the operands
// swap: the slab rows take the row axis (128, 8 warps of one m16 tile) and
// the queries the n8-granular column axis, 104 a block (13 n8 tiles a warp),
// so 200 queries cost 208 columns; the epilogue stages the tile transposed,
// which keeps the output (Nq, R).  On the H100 this tile was 4% faster than
// the 128 x 128 one at 256 x 200 x 256 x 256 (PERF.md).

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int TK = 32;                  // depth of one stage
constexpr int TLD = TK + 4;             // staged row stride (words)
constexpr int STAGES = 3;
constexpr int THREADS = 256;            // 8 warps

// One output tile of a (na x m) by (nb x m) product: rows of A on the m16
// axis, rows of B on the n8 axis; with Q_ON_N the queries are B and the
// output (queries x series) is written transposed.
template <int WARPS_M, int WARPS_N, int MI, int NI, bool Q_ON_N>
struct Tile {
  static constexpr int TM = WARPS_M * 16 * MI;   // A rows per block
  static constexpr int TN = WARPS_N * 8 * NI;    // B rows per block
  static constexpr int TQ = Q_ON_N ? TN : TM;    // query rows of the tile
  static constexpr int TS = Q_ON_N ? TM : TN;    // series rows of the tile
  static constexpr int STAGE_FLOATS = (TM + TN) * TLD;
  static constexpr int OLD = TS + 4;             // staged output row stride
  static constexpr int SMEM = STAGES * STAGE_FLOATS * sizeof(float);
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  static_assert(TQ * OLD <= STAGES * STAGE_FLOATS, "output tile fits");
  static_assert(TM + TN <= THREADS, "a thread per norm");
  static_assert(TS % 4 == 0, "whole float4s per staged output row");
  static_assert(!Q_ON_N || OLD % 32 == 4, "conflict-free transposed stores");
};

template <int WARPS_M, int WARPS_N, int MI, int NI, bool Q_ON_N>
__device__ __forceinline__ void l2_tile(const float* __restrict__ q,
                                        const float* __restrict__ s,
                                        float* __restrict__ out, int nq,
                                        int ns, int m, int vec_in,
                                        int vec_out, float* smem) {
  using T = Tile<WARPS_M, WARPS_N, MI, NI, Q_ON_N>;
  constexpr int TM = T::TM, TN = T::TN, TQ = T::TQ, TS = T::TS;
  constexpr int OLD = T::OLD, STAGE_FLOATS = T::STAGE_FLOATS;
  __shared__ float an[TM];              // |A row|^2
  __shared__ float bn[TN];              // |B row|^2

  const float* a_src = Q_ON_N ? s : q;
  const float* b_src = Q_ON_N ? q : s;
  const int na = Q_ON_N ? ns : nq;
  const int nb = Q_ON_N ? nq : ns;
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
  float norm = 0.f;   // threads 0..TM-1: |A row|^2, then TN |B row|^2

  auto load = [&](int stage, int k_stage) {
    float* a = smem + stage * STAGE_FLOATS;
    tf32x3::stage_tile<float, TM, TK, TLD, THREADS>(
        a, a_src, row0, na, k_stage * TK, m, vec_in, tid);
    tf32x3::stage_tile<float, TN, TK, TLD, THREADS>(
        a + TM * TLD, b_src, col0, nb, k_stage * TK, m, vec_in, tid);
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

  if (tid < TM) an[tid] = norm;
  else if (tid < TM + TN) bn[tid - TM] = norm;
  __syncthreads();                      // norms written, the ring is free

  float* tile = smem;                   // [TQ][OLD] distances
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 * MI + i * 16 + g + half * 8;   // A row
        const int c = wn * 8 * NI + j * 8 + 2 * t;            // B rows c, c+1
        const float d0 =
            sqrtf(fmaxf(an[r] + bn[c] - 2.f * dot[i][j][2 * half], 0.f));
        const float d1 = sqrtf(
            fmaxf(an[r] + bn[c + 1] - 2.f * dot[i][j][2 * half + 1], 0.f));
        if (Q_ON_N) {   // transposed: lanes (g, t) hit banks 8t + g
          tile[c * OLD + r] = d0;
          tile[(c + 1) * OLD + r] = d1;
        } else {
          *reinterpret_cast<float2*>(tile + r * OLD + c) = make_float2(d0, d1);
        }
      }
  __syncthreads();

  const int q0 = Q_ON_N ? col0 : row0;  // first query row of the tile
  const int s0 = Q_ON_N ? row0 : col0;  // first series row of the tile
  if (vec_out) {                        // ns % 4 == 0: whole float4s
    for (int e = tid; e < TQ * TS / 4; e += THREADS) {
      const int r = e / (TS / 4), c = (e % (TS / 4)) * 4;
      if (q0 + r < nq && s0 + c < ns)
        *reinterpret_cast<float4*>(out + (long long)(q0 + r) * ns + s0 + c) =
            *reinterpret_cast<const float4*>(tile + r * OLD + c);
    }
  } else {
    for (int e = tid; e < TQ * TS; e += THREADS) {
      const int r = e / TS, c = e % TS;
      if (q0 + r < nq && s0 + c < ns)
        out[(long long)(q0 + r) * ns + s0 + c] = tile[r * OLD + c];
    }
  }
}

// ---- pairwise_l2 ---------------------------------------------------------

using PairTile = Tile<2, 4, 4, 4, false>;

__global__ void __launch_bounds__(THREADS, 1)
l2_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int nq, int ns, int m, int vec_in,
                 int vec_out) {
  extern __shared__ __align__(16) float smem[];
  l2_tile<2, 4, 4, 4, false>(q, s, out, nq, ns, m, vec_in, vec_out, smem);
}

int launch_pairwise(const float* q, const float* s, float* out, int nq,
                    int ns, int m, cudaStream_t stream) {
  if (nq <= 0 || ns <= 0) return cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      l2_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PairTile::SMEM);
  if (err != cudaSuccess) return err;
  const int vec_in =
      m % 4 == 0 && tf32x3::aligned16(q) && tf32x3::aligned16(s);
  const int vec_out = ns % 4 == 0 && tf32x3::aligned16(out);
  dim3 grid((ns + PairTile::TN - 1) / PairTile::TN,
            (nq + PairTile::TM - 1) / PairTile::TM);
  l2_tf32x3_kernel<<<grid, THREADS, PairTile::SMEM, stream>>>(
      q, s, out, nq, ns, m, vec_in, vec_out);
  return cudaGetLastError();
}

// ---- slab_l2 -------------------------------------------------------------

using SlabTile = Tile<8, 1, 1, 13, true>;   // 128 slab rows x 104 queries

__global__ void __launch_bounds__(THREADS, 1)
slab_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, int nq, int ns, int m,
                   long long q_stride, long long s_stride,
                   long long o_stride, int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const long long b = blockIdx.z;
  l2_tile<8, 1, 1, 13, true>(q + b * q_stride, s + b * s_stride,
                             out + b * o_stride, nq, ns, m, vec_in, vec_out,
                             smem);
}

int launch_slab(const float* q, const float* s, float* out, int batch,
                int nq, int ns, int m, cudaStream_t stream) {
  if (batch <= 0 || nq <= 0 || ns <= 0) return cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      slab_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SlabTile::SMEM);
  if (err != cudaSuccess) return err;
  // every slab's base, not only the first, must sit on 16 bytes
  const int vec_in =
      m % 4 == 0 && tf32x3::aligned16(q) && tf32x3::aligned16(s);
  const int vec_out = ns % 4 == 0 && tf32x3::aligned16(out);
  // slab rows on the tile's m16 axis, queries on its n8 axis
  dim3 grid((nq + SlabTile::TN - 1) / SlabTile::TN,
            (ns + SlabTile::TM - 1) / SlabTile::TM, batch);
  slab_tf32x3_kernel<<<grid, THREADS, SlabTile::SMEM, stream>>>(
      q, s, out, nq, ns, m, (long long)nq * m, (long long)ns * m,
      (long long)nq * ns, vec_in, vec_out);
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
  return launch_slab(static_cast<const float*>(queries),
                     static_cast<const float*>(slabs),
                     static_cast<float*>(out), F, Nq, R, m,
                     static_cast<cudaStream_t>(stream));
}
