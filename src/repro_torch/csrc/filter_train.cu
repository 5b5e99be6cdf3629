// Filter training for Hopper (sm_90a): one SGD-with-momentum step of every
// filter MLP at once, as two kernels.
//
// Replaces no Pallas kernel: the reference's step is the jitted program
// _train_filters_jit (src/repro/core/filter_training.py:274; loss_fn :288,
// _sgd_step :267, the lax.scan over steps :340), which XLA fuses.  A step
// trains filter f on R = bg + bl rows: the bg global rows xg[ig] (shared by
// every filter) and its own bl local rows xl[f, il] (bl = bg / 4; R = 160 at
// the default batch of 128; the rows repeat, as the indices are drawn with
// replacement).
//
//   train_forward       pre = X.w1[f] + b1[f], pred = relu(pre).w2[f] + b2[f]
//                       dpred = (pred - y) * (1 - mask) * c   -> (F, R)
//                       with c = 2 w_g / (F bg) on global rows and
//                       2 (1 - w_g) / (F bl) on local rows (the reference's
//                       means); masked (validation) rows are computed and
//                       get 0.
//   train_backward_sgd  per (filter, 128-lane hidden chunk): pre recomputed,
//                       dpre = (dpred x w2) * [pre > 0], g_w2 = H^T.dpred,
//                       g_b1 = sum dpre, g_w1 = X^T.dpre; then for w1, b1,
//                       w2 of the chunk (b2 in the chunk-0 block)
//                       v <- mu*v + g, p <- p - lr*v (_sgd_step's order, no
//                       fused multiply-add).  Parameters and velocities are
//                       updated in place; neither the gradients nor the
//                       hidden activations reach device memory.
//
// Bound on an H100 at a DSTree build (F = 4096, m = h = 256, R = 160): the
// products are 2*F*R*m*h = 85.9 GFLOP three times (forward, recompute,
// w1 gradient), 1.56 ms as three split-TF32 passes at 495 TFLOP/s (3.85 on
// the float32 CUDA cores); the bytes are w1 read by the forward kernel and
// w1 and its velocity each read and written by the update, 5 x 1.07 GB plus
// the gathered rows, 1.64 ms at 3.35 TB/s.  Recomputing pre costs a third
// of the products and no bytes (a block's w1 chunk, 128 KB, is read again
// by its own update from L2); the other way, a relu bit-mask written by the
// forward kernel (F*R*h bits, 21 MB here), would not give g_w2, which needs
// relu(pre) itself.
//
// Both kernels take the layer-1 products as filter_mlp.cu's tile design
// does: 8 warps over a 160-row x 128-lane tile (2 x 4 warps, five m16 row
// tiles and four n8 lane tiles each), m in 32-deep stages through a ring of
// 3 cp.async stages, split-TF32 mma.sync (tf32x3.cuh), three products per
// float32 multiply-add, all m into one accumulator.  The block gathers its
// own rows: it reads the step's index rows by pointer and keeps one row
// pointer per tile row in shared memory; rows past R are zero.  A larger
// batch (R > 160) takes 160-row tiles in turn: the forward kernel's block
// loops over them and writes each tile's dpred; the backward kernel is
// launched once per tile, and each tile adds its gradients into the
// velocities (v <- mu*v + g on the first tile, v += g on each later one,
// p <- p - lr*v on the last), so no gradient reaches memory either; at
// one tile this is the update above, rounding for rounding.  Both
// kernels run the same layer-1 code, so the recomputed pre equals the
// forward kernel's bit for bit.  g_w1 = X^T.dpre runs on the same body:
// dpre goes to shared memory, the X rows are restaged 64 columns of m at a
// time (double-buffered), 2 x 4 warps over a 64 x 128 output tile; the sum
// over the R rows takes 32 rows a stage on the tensor cores and the stage
// sums in float32, to nearest (the tensor cores round each step toward zero;
// the l2 kernels sum the same way).  Each pass loads the w1 and velocity
// values its update needs into registers before its products, so their
// latency hides behind the tensor cores (one block fills an SM, so no other
// block's products would hide it); that puts the kernel at the card's cap
// of 255 registers a thread, with no spills.  The tiles of a larger batch
// run a second instance that loads them after the products instead (the
// tile's runtime flags leave no room for the early load: it spilled).
// Ragged m and h are zero-filled or masked; m % 4 != 0 or h % 4 != 0 stage
// element by element and update element by element.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int WARPS_M = 2;              // warps along the rows
constexpr int WARPS_N = 4;              // warps along the hidden lanes
constexpr int MI = 5;                   // m16 row tiles per warp
constexpr int NI = 4;                   // n8 lane tiles per warp
constexpr int ROWS = WARPS_M * 16 * MI;     // 160 rows a step
constexpr int LANES = WARPS_N * 8 * NI;     // 128 hidden lanes a chunk
constexpr int TK = 32;                  // stage depth over m
constexpr int XLD = TK + 4;             // staged row stride (words)
constexpr int WLD = LANES + 8;          // staged w1 row stride: k-rows 8 banks apart
constexpr int STAGES = 3;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int X_STAGE = ROWS * XLD;     // floats
constexpr int W_STAGE = TK * WLD;
constexpr int RING_BYTES = STAGES * (X_STAGE + W_STAGE) * 4;  // 118.5 KB

// the w1 gradient: 64 columns of m a pass, 2 x 4 warps of 32 x 32
constexpr int MC = 64;
constexpr int MI2 = 2;
constexpr int NI2 = 4;
constexpr int XTLD = MC + 8;            // staged X row stride: A loads conflict-free
constexpr int DLD = LANES + 8;          // dpre row stride: B loads conflict-free
constexpr int DPRE_FLOATS = ROWS * DLD;
constexpr int XT_FLOATS = ROWS * XTLD;
constexpr int GRAD_BYTES = (DPRE_FLOATS + 2 * XT_FLOATS) * 4;  // 175 KB
constexpr int BWD_BYTES = RING_BYTES > GRAD_BYTES ? RING_BYTES : GRAD_BYTES;

// one row pointer per row of the tile that starts at step row r0: the step's
// global rows first, then the filter's own local rows, nullptr (zero rows)
// past R = bg + bl
__device__ __forceinline__ void gather_rows(
    const float** rows, const float* __restrict__ xg,
    const float* __restrict__ xl, const int64_t* __restrict__ ig,
    const int64_t* __restrict__ il, int f, int m, int n_l, int bg, int bl,
    int r0, int tid) {
  for (int r = tid; r < ROWS; r += THREADS) {
    const int rr = r0 + r;
    const float* p = nullptr;
    if (rr < bg)
      p = xg + ig[rr] * m;
    else if (rr < bg + bl)
      p = xl + ((long long)f * n_l + il[rr - bg]) * m;
    rows[r] = p;
  }
}

// dst[ROWS][LD] <- columns [c0, c0 + COLS) of the gathered rows, zeros past
// m and for null rows; vec: 16-byte cp.async (m % 4 == 0, rows 16-byte
// aligned), else element copies (published by the caller's __syncthreads)
template <int COLS, int LD>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* const* rows,
                                           const float* any, int c0, int m,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int CPR = COLS / 4;
    for (int e = tid; e < ROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 4;
      const float* p = rows[r];
      const bool ok = p != nullptr && c0 + c < m;
      tf32x3::cp_async16(dst + r * LD + c, ok ? p + c0 + c : any, ok);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const float* p = rows[r];
      dst[r * LD + c] = p != nullptr && c0 + c < m ? p[c0 + c] : 0.f;
    }
  }
}

// acc <- X . W1[:, h0 : h0 + LANES] for the tile's gathered rows, over all
// of m through the cp.async ring (tf32x3.cuh, shared with filter_mlp.cu's
// tile kernel); returns with the ring drained and free.  Thread (warp wm,
// wn; g = lane / 4, t = lane % 4) holds rows wm*80 + i*16 + g (+8) and
// lanes wn*32 + j*8 + 2t (+1) of the tile.
__device__ __forceinline__ void layer1_chunk(
    float (&acc)[MI][NI][4], const float* const* rows, const float* any,
    const float* __restrict__ W1, int m, int h, int h0, bool xvec, bool wvec,
    float* ring, int tid) {
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  auto xs = [&](int st) { return ring + st * (X_STAGE + W_STAGE); };
  auto ws = [&](int st) { return ring + st * (X_STAGE + W_STAGE) + X_STAGE; };
  auto load = [&](int s) {
    const int st = s % STAGES;
    stage_rows<TK, XLD>(xs(st), rows, any, s * TK, m, xvec, tid);
    tf32x3::stage_tile<float, TK, LANES, WLD, THREADS>(ws(st), W1, s * TK, m,
                                                        h0, h, wvec, tid);
  };
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  tf32x3::cp_async_ring<STAGES>((m + TK - 1) / TK, load, [&](int s) {
    tf32x3::warp_stage<MI, NI, TK, XLD, WLD, true>(
        acc, xs(s % STAGES) + wm * 16 * MI * XLD, ws(s % STAGES) + wn * 8 * NI,
        g, t, [](float w) { return w; });
  });
  __syncthreads();                      // every warp is done with the ring
}

// v <- mu*v + g, p <- p - lr*v, each product and sum rounded on its own
__device__ __forceinline__ void sgd(float* p, float* v, float grad, float lr,
                                    float mu) {
  const float nv = __fadd_rn(__fmul_rn(mu, *v), grad);
  *v = nv;
  *p = __fsub_rn(*p, __fmul_rn(lr, nv));
}

// sgd over row tiles: the first tile's gradient makes v <- mu*v + g, each
// later one's is added to v, and the last tile applies p <- p - lr*v (one
// tile: sgd, rounding for rounding)
__device__ __forceinline__ void sgd_tile(float* p, float* v, float grad,
                                         float lr, float mu, bool first,
                                         bool last) {
  const float nv = __fadd_rn(first ? __fmul_rn(mu, *v) : *v, grad);
  *v = nv;
  if (last) *p = __fsub_rn(*p, __fmul_rn(lr, nv));
}

__global__ void __launch_bounds__(THREADS, 1)
train_forward_kernel(const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ xg,
                     const float* __restrict__ xl,
                     const int64_t* __restrict__ ig,
                     const int64_t* __restrict__ il,
                     const float* __restrict__ ygz,
                     const float* __restrict__ ylz,
                     const float* __restrict__ vg,
                     const float* __restrict__ vl, float* __restrict__ dpred,
                     int m, int h, int n_g, int n_l, int bg, int bl, float cg,
                     float cl, int xvec, int wvec) {
  extern __shared__ __align__(16) float ring[];
  __shared__ const float* rows[ROWS];
  __shared__ float red[WARPS_N][ROWS];

  const int f = blockIdx.x;
  const int R = bg + bl;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const float* W1 = w1 + (long long)f * m * h;
  const float* B1 = b1 + (long long)f * h;
  const float* W2 = w2 + (long long)f * h;

  // a step of more than ROWS rows takes its row tiles one after another; the
  // syncs inside layer1_chunk order each tile's reads of rows and red before
  // the next tile writes them
  for (int r0 = 0; r0 < R; r0 += ROWS) {
    gather_rows(rows, xg, xl, ig, il, f, m, n_l, bg, bl, r0, tid);
    __syncthreads();

    float z[MI][2] = {};                // rows wm*80 + i*16 + g (+8)
    float acc[MI][NI][4];
    for (int h0 = 0; h0 < h; h0 += LANES) {
      layer1_chunk(acc, rows, xg, W1, m, h, h0, xvec, wvec, ring, tid);
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ln = h0 + wn * 8 * NI + j * 8 + 2 * t + c;
          if (ln >= h) continue;
          const float bj = B1[ln], wj = W2[ln];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              z[i][half] = fmaf(fmaxf(acc[i][j][2 * half + c] + bj, 0.f), wj,
                                z[i][half]);
        }
    }

    // the 4 threads of a quad hold one row's lanes 2t, 2t + 1
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        z[i][half] += __shfl_xor_sync(0xffffffffu, z[i][half], 1);
        z[i][half] += __shfl_xor_sync(0xffffffffu, z[i][half], 2);
        if (t == 0) red[wn][wm * 16 * MI + i * 16 + g + half * 8] = z[i][half];
      }
    __syncthreads();
    const int r = r0 + tid;
    if (tid < ROWS && r < R) {
      float pred = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS_N; ++w) pred += red[w][tid];
      pred += b2[f];
      float y, mask, coef;
      if (r < bg) {
        const long long i = ig[r];
        y = ygz[(long long)f * n_g + i];
        mask = vg[i];
        coef = cg;
      } else {
        const long long i = il[r - bg];
        y = ylz[(long long)f * n_l + i];
        mask = vl[i];
        coef = cl;
      }
      dpred[(long long)f * R + r] = (pred - y) * (1.f - mask) * coef;
    }
  }
}

// One row tile of the step, rows [r0, r0 + ROWS).  TILED = false: the only
// tile (r0 = 0, R <= ROWS), each pass loading its w1 and velocity values
// before its products.  TILED = true: one of several tiles, launched in
// turn; each of the eight tensors' gradient goes into its velocity
// (sgd_tile: v <- mu*v + g on the first tile, v += g on later ones, p <- p
// - lr*v on the last), and each pass loads its values after its products,
// as the tile's flags leave no registers for the early load (it spilled).
template <bool TILED>
__global__ void __launch_bounds__(THREADS, 1)
train_backward_sgd_kernel(float* __restrict__ w1, float* __restrict__ b1,
                          float* __restrict__ w2, float* __restrict__ b2,
                          float* __restrict__ vw1, float* __restrict__ vb1,
                          float* __restrict__ vw2, float* __restrict__ vb2,
                          const float* __restrict__ xg,
                          const float* __restrict__ xl,
                          const int64_t* __restrict__ ig,
                          const int64_t* __restrict__ il,
                          const float* __restrict__ dpred, int m, int h,
                          int n_l, int bg, int bl, int chunks, float lr,
                          float mu, int xvec, int wvec, int tile_r0,
                          int tile_first, int tile_last) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* rows[ROWS];
  __shared__ float dp[ROWS];
  __shared__ float red[2][WARPS_M][LANES];  // g_w2, g_b1 per row warp

  const int r0 = TILED ? tile_r0 : 0;
  const bool first = !TILED || tile_first;
  const bool last = !TILED || tile_last;
  const int f = blockIdx.x / chunks;
  const int h0 = (blockIdx.x % chunks) * LANES;
  const int R = bg + bl;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float* W1 = w1 + (long long)f * m * h;
  float* VW1 = vw1 + (long long)f * m * h;
  const long long fh = (long long)f * h;
  gather_rows(rows, xg, xl, ig, il, f, m, n_l, bg, bl, r0, tid);
  for (int r = tid; r < ROWS; r += THREADS)
    dp[r] = r0 + r < R ? dpred[(long long)f * R + r0 + r] : 0.f;
  __syncthreads();

  float acc[MI][NI][4];
  layer1_chunk(acc, rows, xg, W1, m, h, h0, xvec, wvec, smem, tid);

  // the ring is free: dpre and two X tiles take its place; the first X
  // tile is in flight while dpre is formed
  float* dpre = smem;                   // [ROWS][DLD]
  float* xt = smem + DPRE_FLOATS;       // 2 x [ROWS][XTLD]
  stage_rows<MC, XTLD>(xt, rows, xg, 0, m, xvec, tid);
  tf32x3::cp_async_commit();

  float gw2[NI][2] = {}, gb1[NI][2] = {};
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = wn * 8 * NI + j * 8 + 2 * t + c;
      const bool ok = h0 + col < h;
      const float bj = ok ? b1[fh + h0 + col] : 0.f;
      const float wj = ok ? w2[fh + h0 + col] : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 16 * MI + i * 16 + g + half * 8;
          const float pre = acc[i][j][2 * half + c] + bj;
          const float d = dp[r];
          const float e = pre > 0.f ? d * wj : 0.f;
          gw2[j][c] = fmaf(fmaxf(pre, 0.f), d, gw2[j][c]);
          gb1[j][c] += e;
          dpre[r * DLD + col] = e;
        }
    }
  // sum over the 8 row groups of the warp, then over the two row warps
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        gw2[j][c] += __shfl_xor_sync(0xffffffffu, gw2[j][c], o);
        gb1[j][c] += __shfl_xor_sync(0xffffffffu, gb1[j][c], o);
      }
      if (g == 0) {
        const int col = wn * 8 * NI + j * 8 + 2 * t + c;
        red[0][wm][col] = gw2[j][c];
        red[1][wm][col] = gb1[j][c];
      }
    }
  __syncthreads();                      // red, dpre written; w2, b1 read
  if (tid < LANES && h0 + tid < h) {
    const long long i = fh + h0 + tid;
    sgd_tile(w2 + i, vw2 + i, red[0][0][tid] + red[0][1][tid], lr, mu, first,
             last);
    sgd_tile(b1 + i, vb1 + i, red[1][0][tid] + red[1][1][tid], lr, mu, first,
             last);
  }
  if (h0 == 0 && warp == 0) {           // b2: one block per filter
    float s = 0.f;
    for (int r = lane; r < ROWS; r += 32) s += dp[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sgd_tile(b2 + f, vb2 + f, s, lr, mu, first, last);
  }

  // g_w1[:, chunk] = X^T . dpre, then the update, MC columns of m a pass
  const int passes = (m + MC - 1) / MC;
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes)
      stage_rows<MC, XTLD>(xt + ((p + 1) % 2) * XT_FLOATS, rows, xg,
                           (p + 1) * MC, m, xvec, tid);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();                    // tile p (and dpre) visible
    const float* X = xt + (p % 2) * XT_FLOATS;
    // the w1 and velocity values of lanes ln, ln + 1 in row k
    auto load_wv = [&](int k, int ln, float2& a, float2& b) {
      const long long o = (long long)k * h + ln;
      a = make_float2(0.f, 0.f), b = a;
      if (k < m && ln < h && wvec) {
        a = *reinterpret_cast<const float2*>(W1 + o);
        b = *reinterpret_cast<const float2*>(VW1 + o);
      } else if (k < m) {
        if (ln < h) a.x = W1[o], b.x = VW1[o];
        if (ln + 1 < h) a.y = W1[o + 1], b.y = VW1[o + 1];
      }
    };
    // one tile: this pass's values, loaded while the products run
    float2 pw[MI2][2][NI2], pv[MI2][2][NI2];
    if constexpr (!TILED) {
#pragma unroll
      for (int i = 0; i < MI2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < NI2; ++j)
            load_wv(p * MC + wm * 16 * MI2 + i * 16 + g + half * 8,
                    h0 + wn * 8 * NI2 + j * 8 + 2 * t, pw[i][half][j],
                    pv[i][half][j]);
    }
    float acc2[MI2][NI2][4], tot[MI2][NI2][4];
#pragma unroll
    for (int i = 0; i < MI2; ++i)
#pragma unroll
      for (int j = 0; j < NI2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;
    for (int q0 = 0; q0 < ROWS; q0 += TK) {
#pragma unroll
      for (int i = 0; i < MI2; ++i)
#pragma unroll
        for (int j = 0; j < NI2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 8) {
        uint32_t bh[NI2][2], bl[NI2][2];
#pragma unroll
        for (int j = 0; j < NI2; ++j) {   // B[k][n] = dpre[row][lane]
          const float* b = dpre + (q0 + kk + t) * DLD + wn * 8 * NI2 + j * 8
                           + g;
          tf32x3::split(b[0], bh[j][0], bl[j][0]);
          tf32x3::split(b[4 * DLD], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MI2; ++i) {   // A[i][k] = X[row k][column i]
          const float* a = X + (q0 + kk + t) * XTLD + wm * 16 * MI2 + i * 16
                           + g;
          uint32_t ah[4], al[4];
          tf32x3::split(a[0], ah[0], al[0]);
          tf32x3::split(a[8], ah[1], al[1]);
          tf32x3::split(a[4 * XTLD], ah[2], al[2]);
          tf32x3::split(a[4 * XTLD + 8], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NI2; ++j)
            tf32x3::mma3(acc2[i][j], ah, al, bh[j], bl[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MI2; ++i)     // the stage's sum, to nearest
#pragma unroll
        for (int j = 0; j < NI2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[i][j][e] += acc2[i][j][e];
    }
#pragma unroll
    for (int i = 0; i < MI2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = p * MC + wm * 16 * MI2 + i * 16 + g + half * 8;
        if (k >= m) continue;
#pragma unroll
        for (int j = 0; j < NI2; ++j) {
          const int ln = h0 + wn * 8 * NI2 + j * 8 + 2 * t;
          const long long o = (long long)k * h + ln;
          float2 w, v;
          if constexpr (TILED)
            load_wv(k, ln, w, v);
          else
            w = pw[i][half][j], v = pv[i][half][j];
          sgd_tile(&w.x, &v.x, tot[i][j][2 * half], lr, mu, first, last);
          sgd_tile(&w.y, &v.y, tot[i][j][2 * half + 1], lr, mu, first, last);
          if (wvec) {
            if (ln >= h) continue;
            *reinterpret_cast<float2*>(W1 + o) = w;
            *reinterpret_cast<float2*>(VW1 + o) = v;
          } else {
            if (ln < h) W1[o] = w.x, VW1[o] = v.x;
            if (ln + 1 < h) W1[o + 1] = w.y, VW1[o + 1] = v.y;
          }
        }
      }
    __syncthreads();                    // tile p is free for pass p + 2
  }
}

}  // namespace

// w1 (F, m, h), b1 and w2 (F, h), b2 (F,); xg (n_g, m), xl (F, n_l, m); ig
// (bg,) and il (bl,) int64 row indices; ygz (F, n_g), ylz (F, n_l); vg (n_g,),
// vl (n_l,) -> dpred (F, bg + bl); all contiguous, float32 but the indices.
extern "C" int train_forward(const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* xg, const void* xl,
                             const void* ig, const void* il, const void* ygz,
                             const void* ylz, const void* vg, const void* vl,
                             void* dpred, int F, int m, int h, int n_g,
                             int n_l, int bg, int bl, float cg, float cl,
                             void* stream) {
  if (bg < 1 || bl < 1) return cudaErrorInvalidValue;
  if (F <= 0) return cudaGetLastError();
  const int xvec = m % 4 == 0 && tf32x3::aligned16(xg) &&
                   tf32x3::aligned16(xl);
  const int wvec = h % 4 == 0 && tf32x3::aligned16(w1);
  cudaError_t err = cudaFuncSetAttribute(
      train_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RING_BYTES);
  if (err != cudaSuccess) return err;
  train_forward_kernel<<<F, THREADS, RING_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(xg), static_cast<const float*>(xl),
      static_cast<const int64_t*>(ig), static_cast<const int64_t*>(il),
      static_cast<const float*>(ygz), static_cast<const float*>(ylz),
      static_cast<const float*>(vg), static_cast<const float*>(vl),
      static_cast<float*>(dpred), m, h, n_g, n_l, bg, bl, cg, cl, xvec,
      wvec);
  return cudaGetLastError();
}

// the parameters (as train_forward) and their velocities, updated in place;
// xg, xl, ig, il as train_forward; dpred (F, bg + bl) from it.
extern "C" int train_backward_sgd(void* w1, void* b1, void* w2, void* b2,
                                  void* vw1, void* vb1, void* vw2, void* vb2,
                                  const void* xg, const void* xl,
                                  const void* ig, const void* il,
                                  const void* dpred, int F, int m, int h,
                                  int n_l, int bg, int bl, float lr, float mu,
                                  void* stream) {
  if (bg < 1 || bl < 1) return cudaErrorInvalidValue;
  if (F <= 0 || h <= 0) return cudaGetLastError();
  const int chunks = (h + LANES - 1) / LANES;
  const long long blocks = (long long)F * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int xvec = m % 4 == 0 && tf32x3::aligned16(xg) &&
                   tf32x3::aligned16(xl);
  const int wvec = h % 4 == 0 && tf32x3::aligned16(w1) &&
                   tf32x3::aligned16(vw1);
  const int R = bg + bl;
  auto kernel = R > ROWS ? train_backward_sgd_kernel<true>
                         : train_backward_sgd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_BYTES);
  if (err != cudaSuccess) return err;
  // one launch a row tile, in stream order: each tile reads the parameters
  // the last one alone updates
  for (int r0 = 0; r0 < R; r0 += ROWS) {
    kernel<<<(unsigned)blocks, THREADS, BWD_BYTES,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(w1), static_cast<float*>(b1),
        static_cast<float*>(w2), static_cast<float*>(b2),
        static_cast<float*>(vw1), static_cast<float*>(vb1),
        static_cast<float*>(vw2), static_cast<float*>(vb2),
        static_cast<const float*>(xg), static_cast<const float*>(xl),
        static_cast<const int64_t*>(ig), static_cast<const int64_t*>(il),
        static_cast<const float*>(dpred), m, h, n_l, bg, bl, chunks, lr, mu,
        xvec, wvec, r0, r0 == 0, r0 + ROWS >= R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
