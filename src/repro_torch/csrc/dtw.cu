// Sakoe-Chiba-banded dynamic time warping for Hopper (sm_90a): the DTW
// distance of every (query, series) pair, (Q, N), in one launch.
//
// Replaces no Pallas kernel: the reference computes DTW as a jitted lax.scan
// over the rows of the full m x m table, the in-row left dependency an
// inner lax.scan (src/repro/core/dtw.py:29 dtw).  With D[-1, -1] = 0, the
// rest of row -1 at INF = 1e30, and |i - j| <= r in band:
//   D[i, j] = min((q_i - x_j)^2 + min(min(D[i-1, j], D[i-1, j-1]),
//                                     D[i, j-1]), INF)
// an out-of-band cell exactly INF, and the distance sqrt(D[m-1, m-1]).  A
// band of m - 1 or more is full DTW (r = min(band, m - 1) below).
//
// Bound on an H100: an in-band cell is six float32 operations (sub, mul,
// min, min, add, min; none fuses into an FMA), m (2r + 1) - r (r + 1) cells
// a pair.  At the DSTree phase's call (8 queries x 1,000,000 series, m =
// 256, r = 8) that is 3.4e10 cells, 2.05e11 operations: 6.1 ms at the CUDA
// cores' 33.5 T non-FMA operations/s, against 1.0 GB of series (0.31 ms at
// 3.35 TB/s).  Operations bound it.
//
// Bitwise equal to the reference: each step is one correctly rounded
// operation in the reference's order (__fsub_rn, __fmul_rn, __fadd_rn keep
// nvcc from contracting d * d + t into an FMA), the minima propagate NaN as
// jnp.minimum does (min.NaN), and the root is sqrt_rn.
//
// Design (first version; making it fast is later work):
//   * One thread a (query, series) pair.  The row's band frame, f[k] = D[i,
//     i - r + k] for k = 0 .. 2r, is updated in place in increasing k: cell
//     k reads the previous row's f[k] (diag) and f[k + 1] (up, INF past
//     2r) before either is overwritten, and the new f[k - 1] (left).
//   * BAND instances (DTW_BANDS: r = 8, the reference's default, and 2, 3,
//     4, 6) keep the frame and the series' window x[i - r .. i + r] in
//     registers.  The rows run in blocks of W = 2r + 1, unrolled, so that
//     x_j sits in slot (j + r) % W at a compile-time index and a row loads
//     one new value, x[i + r].  The first block is peeled: its cells left
//     of column 0 are skipped at compile time (they stay INF); cells right
//     of column m - 1 compute on staged zeros and are never read by a cell
//     inside the table.
//   * A block is 128 threads: qb queries (1, 2, 4 or 8 by Q) x 128 / qb
//     series.  The queries sit in shared memory (an odd row stride, so the
//     query slots of a warp read different banks); each block of W rows
//     stages the next W columns of its series through shared memory, read
//     from device memory once per query tile.  A slot past Q or N
//     repeats the last query or series and stores nothing.
//   * Any other band (r = 0, 1, wide bands, full DTW) takes a generic
//     instance: a grid sized to the card, each thread walking pairs with
//     its frame in a scratch buffer laid out [k][thread] (coalesced), the
//     caller's allocation (dtw_scratch_floats says how large).

#include <cuda_runtime.h>

#include <cstdint>

// the bands with an instance of their own (kernels/dtw/kernel.py BANDS)
#define DTW_BANDS(X) X(2) X(3) X(4) X(6) X(8)

namespace {

constexpr float INF = 1e30f;
constexpr int THREADS = 128;
constexpr int MAX_QB = 8;               // queries a block

// jnp.minimum / torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// one in-band cell, in the reference's order and rounding
__device__ __forceinline__ float cell(float qi, float xj, float up,
                                      float diag, float left) {
  const float d = __fsub_rn(qi, xj);
  const float t = min_nan(min_nan(up, diag), left);
  return min_nan(__fadd_rn(__fmul_rn(d, d), t), INF);
}

// row i = i0 + U (i0 a multiple of W): x[i + r] into its slot, then the
// frame in increasing k.  FIRST (i0 = 0): columns j < 0 are skipped.
template <int R, bool FIRST, int U>
__device__ __forceinline__ void band_row(float (&f)[2 * R + 1],
                                         float (&xb)[2 * R + 1], float qi,
                                         float xnew) {
  constexpr int W = 2 * R + 1;
  xb[(U + 2 * R) % W] = xnew;
  float left = INF;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (FIRST && k < R - U) continue;   // column i - R + k < 0: stays INF
    const float up = k + 1 < W ? f[k + 1] : INF;
    f[k] = cell(qi, xb[(U + k) % W], up, f[k], left);
    left = f[k];
  }
}

// rows i0 + U .. i0 + W - 1 of a block, as far as row m - 1; column
// i0 + R + u of the thread's series is stage[u * sp]
template <int R, bool FIRST, int U>
__device__ __forceinline__ void band_rows(float (&f)[2 * R + 1],
                                          float (&xb)[2 * R + 1],
                                          const float* qrow,
                                          const float* stage, int sp, int i0,
                                          int m) {
  if constexpr (U < 2 * R + 1) {
    if (i0 + U < m) {
      band_row<R, FIRST, U>(f, xb, qrow[i0 + U], stage[U * sp]);
      band_rows<R, FIRST, U + 1>(f, xb, qrow, stage, sp, i0, m);
    }
  }
}

// columns i0 + R .. i0 + R + W - 1 of the block's S series, zero past m or
// N, into stage[u * sp + s]
template <int R>
__device__ __forceinline__ void stage_columns(float* stage,
                                              const float* __restrict__ x,
                                              long long n0, int S, int sp,
                                              int i0, int N, int m) {
  constexpr int W = 2 * R + 1;
  for (int e = threadIdx.x; e < S * W; e += THREADS) {
    const int s = e / W, u = e % W;
    const long long n = n0 + s;
    const int col = i0 + R + u;
    stage[u * sp + s] = n < N && col < m ? __ldg(x + n * m + col) : 0.f;
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
dtw_band_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int Q, int N, int m, int qb) {
  constexpr int W = 2 * R + 1;
  extern __shared__ float q_s[];        // qb query rows, mp floats apart
  __shared__ float stage[W * (THREADS + 1)];
  const int S = THREADS / qb, sp = S + 1, mp = m | 1;
  const int slot = threadIdx.x / S, s = threadIdx.x % S;
  const int q0 = blockIdx.y * qb;
  const long long n0 = (long long)blockIdx.x * S, n = n0 + s;
  for (int e = threadIdx.x; e < qb * m; e += THREADS) {
    const int row = e / m, col = e % m;
    q_s[row * mp + col] = __ldg(q + (long long)min(q0 + row, Q - 1) * m +
                                col);
  }
  float f[W], xb[W];
#pragma unroll
  for (int k = 0; k < W; ++k) f[k] = INF;
  f[R] = 0.f;                           // D[-1, -1]
  // x_0 .. x_{R-1} into slots R .. 2R - 1; slots 0 .. R - 1 (columns
  // -R .. -1) are read only by the first block's skipped cells
  const float* xrow = x + (n < N ? n : (long long)N - 1) * m;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    xb[j] = 0.f;
    xb[j + R] = j < m ? __ldg(xrow + j) : 0.f;
  }
  xb[2 * R] = 0.f;
  const float* qrow = q_s + slot * mp;
  stage_columns<R>(stage, x, n0, S, sp, 0, N, m);
  __syncthreads();                      // the query tile and the stage
  band_rows<R, true, 0>(f, xb, qrow, stage + s, sp, 0, m);
  for (int i0 = W; i0 < m; i0 += W) {
    __syncthreads();                    // the last stage has been read
    stage_columns<R>(stage, x, n0, S, sp, i0, N, m);
    __syncthreads();
    band_rows<R, false, 0>(f, xb, qrow, stage + s, sp, i0, m);
  }
  if (q0 + slot < Q && n < N)
    out[(long long)(q0 + slot) * N + n] = __fsqrt_rn(f[R]);
}

// any band r >= 0 (r <= m - 1): a thread walks pairs p = t, t + T, ...
// (query-major, so a warp's stores coalesce) with its frame at
// frame[k * T + t]; only the row's in-band columns [0, m) are computed
__global__ void __launch_bounds__(THREADS)
dtw_any_band_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    float* __restrict__ out, float* __restrict__ frame, int Q,
                    int N, int m, int r) {
  const long long T = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int W = 2 * r + 1;
  float* f = frame + t;
  for (long long p = t; p < (long long)Q * N; p += T) {
    const float* qrow = q + p / N * m;
    const float* xrow = x + p % N * m;
    for (int k = 0; k < W; ++k) f[k * T] = INF;
    f[r * T] = 0.f;                     // D[-1, -1]
    for (int i = 0; i < m; ++i) {
      const float qi = __ldg(qrow + i);
      const int lo = max(0, r - i), hi = min(2 * r, m - 1 - i + r);
      float left = INF, diag = f[lo * T];
      for (int k = lo; k <= hi; ++k) {
        const float up = k + 1 < W ? f[(k + 1) * T] : INF;
        left = cell(qi, __ldg(xrow + i - r + k), up, diag, left);
        f[k * T] = left;
        diag = up;
      }
    }
    out[p] = __fsqrt_rn(f[r * T]);
  }
}

int effective_band(int m, int band) { return band < m - 1 ? band : m - 1; }

bool has_instance(int r) {
#define DTW_IS(R) || r == R
  return false DTW_BANDS(DTW_IS);
#undef DTW_IS
}

// queries a block: 1, 2, 4 or 8 by Q, fewer where the query rows would
// take more than 96 KB of shared memory
int queries_a_block(int Q, int m) {
  int qb = Q >= 5 ? MAX_QB : Q >= 3 ? 4 : Q;
  while (qb > 1 && (long long)qb * (m | 1) * 4 > (96 << 10)) qb /= 2;
  return qb;
}

template <int R>
cudaError_t launch_band(const float* q, const float* x, float* out, int Q,
                        int N, int m, cudaStream_t stream) {
  const int qb = queries_a_block(Q, m);
  const int S = THREADS / qb;
  const size_t smem = (size_t)qb * (m | 1) * sizeof(float);
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        dtw_band_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + S - 1) / S, (Q + qb - 1) / qb);
  dtw_band_kernel<R><<<grid, THREADS, smem, stream>>>(q, x, out, Q, N, m,
                                                      qb);
  return cudaGetLastError();
}

// threads of the generic instance: a resident grid, no more than the pairs
cudaError_t any_band_threads(long long pairs, long long* threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dtw_any_band_kernel, THREADS, 0);
  const long long card = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (pairs + THREADS - 1) / THREADS;
  *threads = (need < card ? need : card) * THREADS;
  return err;
}

}  // namespace

// floats of scratch a call needs: 0 for a band with its own instance, else
// (2r + 1) x the generic instance's threads
extern "C" int dtw_scratch_floats(int Q, int N, int m, int band,
                                  long long* floats) {
  *floats = 0;
  if (Q <= 0 || N <= 0 || m <= 0 || band < 0) return cudaSuccess;
  const int r = effective_band(m, band);
  if (has_instance(r)) return cudaSuccess;
  long long threads = 0;
  const cudaError_t err = any_band_threads((long long)Q * N, &threads);
  *floats = (2LL * r + 1) * threads;
  return err;
}

// q (Q, m), x (N, m) -> out (Q, N); all contiguous float32; scratch holds
// dtw_scratch_floats(Q, N, m, band) floats
extern "C" int dtw(const void* q, const void* x, void* out, void* scratch,
                   int Q, int N, int m, int band, void* stream) {
  if (Q <= 0 || N <= 0) return cudaGetLastError();
  if (m <= 0 || band < 0) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int r = effective_band(m, band);
  switch (r) {
#define DTW_CASE(R) \
  case R:           \
    return launch_band<R>(qf, xf, of, Q, N, m, s);
    DTW_BANDS(DTW_CASE)
#undef DTW_CASE
    default:
      break;
  }
  long long threads = 0;
  const cudaError_t err = any_band_threads((long long)Q * N, &threads);
  if (err != cudaSuccess) return err;
  dtw_any_band_kernel<<<(unsigned)(threads / THREADS), THREADS, 0, s>>>(
      qf, xf, of, static_cast<float*>(scratch), Q, N, m, r);
  return cudaGetLastError();
}
