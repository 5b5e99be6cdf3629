// A warp's running top-k (k smallest values with their ids, ascending), as
// the replay and the candidate-pass kernels keep it.
//
// insert(v, id) puts v after every entry <= v and drops the last entry: fed
// in order, equal values keep their arrival order, which is the order a
// stable ascending sort gives them.  The caller inserts only v < bsf (the
// k-th value), so a +inf or NaN value never enters and the empty entries
// stay (+inf, -1).
//
//   TopK<true>   k <= 32: lane i holds entry i in registers; an insertion
//                is a ballot and a shuffle.
//   TopK<false>  any k: the entries live in the caller's output row (L1/L2
//                resident), read and written by the warp in turns; an
//                insertion counts the entries <= v across the lanes and
//                shifts the tail up 32 at a time.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned TOPK_FULL = 0xffffffffu;

template <bool REG>
struct TopK;

// lane i < k holds entry i
template <>
struct TopK<true> {
  float d = INFINITY;
  long long id = -1;
  float bsf = INFINITY;
  int k, lane;

  __device__ TopK(float*, long long*, int k_, int lane_) : k(k_), lane(lane_) {}

  // v < bsf, so it lands at a position < k
  __device__ __forceinline__ void insert(float v, long long vi) {
    const int pos = __popc(__ballot_sync(TOPK_FULL, lane < k && d <= v));
    const float up = __shfl_up_sync(TOPK_FULL, d, 1);
    const long long up_id = __shfl_up_sync(TOPK_FULL, id, 1);
    if (lane > pos) {
      d = up;
      id = up_id;
    }
    if (lane == pos) {
      d = v;
      id = vi;
    }
    bsf = __shfl_sync(TOPK_FULL, d, k - 1);
  }

  __device__ __forceinline__ void store(float* out_d, long long* out_i) const {
    if (lane < k) {
      out_d[lane] = d;
      out_i[lane] = id;
    }
  }
};

// the row's output buffer, read and written by the warp in turns
template <>
struct TopK<false> {
  float* d;
  long long* id;
  float bsf = INFINITY;
  int k, lane;

  __device__ TopK(float* d_, long long* id_, int k_, int lane_)
      : d(d_), id(id_), k(k_), lane(lane_) {
    for (int i = lane; i < k; i += 32) {
      d[i] = INFINITY;
      id[i] = -1;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void insert(float v, long long vi) {
    int below = 0;
    for (int i = lane; i < k; i += 32) below += d[i] <= v;
    const int pos = __reduce_add_sync(TOPK_FULL, below);
    // entries pos .. k-2 move up one, the top 32 first
    for (int hi = k - 1; hi > pos; hi -= 32) {
      const int i = hi - lane;
      const bool move = i > pos;
      float x = 0.f;
      long long xi = 0;
      if (move) {
        x = d[i - 1];
        xi = id[i - 1];
      }
      __syncwarp();
      if (move) {
        d[i] = x;
        id[i] = xi;
      }
      __syncwarp();
    }
    if (lane == 0) {
      d[pos] = v;
      id[pos] = vi;
    }
    __syncwarp();
    bsf = d[k - 1];
  }

  __device__ __forceinline__ void store(float*, long long*) const {}
};

}  // namespace
