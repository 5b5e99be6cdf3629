// Split-TF32 tensor-core products and cp.async staging for Hopper (sm_90a),
// shared by l2_scan.cu and filter_mlp.cu.
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits, so one TF32 product
// errs by ~2^-11 relative: a TF32 run of the kernels' plain versions misses
// their float32 limits 23-35x.  The split (CUTLASS's "3xTF32") keeps float32
// accuracy on the tensor cores: each float32 operand x becomes
//   hi = x rounded to TF32 (nearest, ties away),  lo = x - hi truncated
// and a.b is taken as lo.hi' + hi.lo' + hi.hi' with float32 accumulation; the
// dropped lo.lo' term and the truncation of lo are ~2^-21 relative.  bfloat16
// and int8 payloads are exact in TF32 (lo = 0), so two products suffice.  The
// split takes two integer and one float operation per element: the
// conversion instruction (cvt.rna.tf32.f32) runs on a narrower pipe, and
// every warp splits the fragments it loads.
//
// The tensor cores round each m16n8k8 step's sum toward zero (published
// measurements of NVIDIA's tensor cores), so a long sum drifts by about half
// an ulp of the accumulator per step, three steps per 8-deep slice.  A kernel
// whose limit is tight against that drift (pairwise_l2) sums each 32-deep
// stage on the tensor cores and the stage sums on the CUDA cores, to
// nearest: the tensor-core accumulator then stays an eighth of the total.
// kernels/l2_scan/ref.py `split_tf32_matmul` emulates both on the CPU.
//
// Everything here is mma.sync (warp-level, register operands loaded from
// shared memory by the kernels).  wgmma reaches the full tensor-core rate
// and takes TF32 operands from shared memory K-major, which pairwise_l2's
// operands are; that, with TMA loads and a producer warp in place of the
// block-wide barrier per stage, is a later step.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// x -> (hi, lo) TF32 operand registers: hi = x rounded to nearest with
// ties away (what cvt.rna.tf32.f32 gives), lo = x - hi (exact) truncated
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a . b, one m16n8k8 step; a: 4 registers (16 x 8, row), b: 2 (8 x 8,
// col), d: 4 floats (16 x 8).  Fragment layout (g = lane / 4, t = lane % 4):
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float32 x float32: three products, the two small terms first
__device__ __forceinline__ void mma3(float* acc, const uint32_t* a_hi,
                                     const uint32_t* a_lo,
                                     const uint32_t* b_hi,
                                     const uint32_t* b_lo) {
  mma(acc, a_lo, b_hi);
  mma(acc, a_hi, b_lo);
  mma(acc, a_hi, b_hi);
}

// float32 x (an operand exact in TF32): two products, the small term first
__device__ __forceinline__ void mma2(float* acc, const uint32_t* a_hi,
                                     const uint32_t* a_lo,
                                     const uint32_t* b) {
  mma(acc, a_lo, b);
  mma(acc, a_hi, b);
}

// ---- cp.async: 16-byte copies global -> shared, ring of stages ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies 16 bytes, or writes 16 zero bytes when !valid (the ragged edge);
// `src` must be a valid address either way
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[ROWS][LD] <- rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a
// row-major (rows x cols) matrix of T, zeros beyond its edges.  vec: 16-byte
// cp.async (needs cols * sizeof(T) % 16 == 0, a 16-byte aligned src, and
// LD * sizeof(T) a multiple of 16), else synchronous element copies (the
// caller's next __syncthreads publishes them, as cp_async_wait does the
// async ones).
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int r0,
                                           int rows, int c0, int cols,
                                           bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = COLS / V;         // 16-byte chunks per staged row
  static_assert(COLS % V == 0, "whole 16-byte chunks");
  if (vec) {
#pragma unroll
    for (int i = 0; i < (ROWS * CPR + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (ROWS * CPR % THREADS != 0 && e >= ROWS * CPR) break;
      const int r = e / CPR, c = (e % CPR) * V;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(dst + r * LD + c,
                 ok ? src + (long long)(r0 + r) * cols + c0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      dst[r * LD + c] = r0 + r < rows && c0 + c < cols
                            ? src[(long long)(r0 + r) * cols + c0 + c]
                            : T();
    }
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tf32x3
