// How the H100's tensor cores round a TF32 product, on crafted inputs: one
// m64n8k8 wgmma.mma_async (A from registers, B from shared memory, K-major,
// 128-byte swizzle: the form filter_train.cu takes) and one m16n8k8
// mma.sync (tf32x3.cuh's form) per case, both accumulating onto C.
//
// Replaces no Pallas kernel.  The split-TF32 kernels' accuracy design rests
// on two properties no other check isolates: each instruction's sum of
// eight exact products and the accumulator is rounded once, toward zero;
// and a float32 operand is read as TF32 by dropping its 13 low mantissa
// bits (filter_train.cu keeps each lo half untruncated in memory).
// kernels/l2_scan/ref.py `split_tf32_matmul` emulates both; chip_smoke.py
// feeds this probe cases whose results differ under every other rounding
// and asserts the emulated one.  A few hundred multiply-adds: no bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

// one case a block of one warpgroup: A (64 x 8), B (8 x 8, B[k][n]), C
// (64 x 8), row-major float32 bits passed as they are -> Dw = C + A.B by
// wgmma (64 x 8), Dm = the same rows 0-15 by mma.sync (16 x 8)
__global__ void __launch_bounds__(128)
tc_rounding_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ C, float* __restrict__ Dw,
                   float* __restrict__ Dm) {
  __shared__ __align__(1024) float bs[8 * 32];  // 8 lines of 128 bytes
  const int cs = blockIdx.x;
  A += cs * 512, B += cs * 64, C += cs * 512, Dw += cs * 512, Dm += cs * 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  for (int e = tid; e < 8 * 32; e += 128) bs[e] = 0.f;
  __syncthreads();
  if (tid < 64) {                        // line n holds B[:, n]
    const int n = tid / 8, k = tid % 8;
    bs[hopper::swz128(n, k) / 4] = B[k * 8 + n];
  }
  hopper::fence_proxy_async();
  __syncthreads();

  const int r = 16 * warp + g;
  uint32_t a[4] = {__float_as_uint(A[r * 8 + t]),
                   __float_as_uint(A[(r + 8) * 8 + t]),
                   __float_as_uint(A[r * 8 + t + 4]),
                   __float_as_uint(A[(r + 8) * 8 + t + 4])};
  float d[4] = {C[r * 8 + 2 * t], C[r * 8 + 2 * t + 1],
                C[(r + 8) * 8 + 2 * t], C[(r + 8) * 8 + 2 * t + 1]};
  float e[4] = {d[0], d[1], d[2], d[3]};
  hopper::wgmma_fence();
  hopper::wgmma_n8(d, a, hopper::desc_sw128(bs), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
  Dw[r * 8 + 2 * t] = d[0], Dw[r * 8 + 2 * t + 1] = d[1];
  Dw[(r + 8) * 8 + 2 * t] = d[2], Dw[(r + 8) * 8 + 2 * t + 1] = d[3];
  if (warp == 0) {
    const uint32_t b[2] = {__float_as_uint(B[t * 8 + g]),
                           __float_as_uint(B[(t + 4) * 8 + g])};
    tf32x3::mma(e, a, b);
    Dm[r * 8 + 2 * t] = e[0], Dm[r * 8 + 2 * t + 1] = e[1];
    Dm[(r + 8) * 8 + 2 * t] = e[2], Dm[(r + 8) * 8 + 2 * t + 1] = e[3];
  }
}

}  // namespace

// A (cases, 64, 8), B (cases, 8, 8), C (cases, 64, 8) -> Dw (cases, 64, 8),
// Dm (cases, 16, 8); float32, contiguous
extern "C" int tc_rounding_probe(const void* A, const void* B, const void* C,
                                 void* Dw, void* Dm, int cases,
                                 void* stream) {
  if (cases <= 0) return cudaGetLastError();
  tc_rounding_kernel<<<cases, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(Dw),
      static_cast<float*>(Dm));
  return cudaGetLastError();
}
