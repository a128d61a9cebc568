// The extract-min candidate-group select of topk_twophase.cu's select_kernel
// (the TPU kernel's algorithm, which chip_smoke.py times beside the radix
// select of select_radix.cuh): one block picks the t smallest of a row of
// group mins in ascending (value, group id) order. lex_less is shared with
// topk_running.cu.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// t passes over row[0, ngroups), each a block-wide argmin over the entries
// that come after the previous pass's winner in (value, id) order: the
// extract-min sequence of the TPU kernel (ties to the lowest group id) without
// a scratch copy of the row. Writes ids[p] and, unless vals is null, vals[p];
// returns the last winner's value (the certificate threshold) to every thread.
// Every thread of the block calls it; blockDim.x is a multiple of 32, <= 1024.
__device__ float block_select_topt(const float* row, int ngroups, int t, float* vals, int* ids) {
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ float win_v;
  __shared__ int win_i;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  float prev_v = -INFINITY;
  int prev_i = -1;
  for (int p = 0; p < t; ++p) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int i = threadIdx.x; i < ngroups; i += blockDim.x) {
      const float v = __ldg(row + i);
      if (lex_less(prev_v, prev_i, v, i) && lex_less(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (lex_less(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : INFINITY;
      bi = lane < nwarps ? wi[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (lex_less(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        win_v = bv;
        win_i = bi;
        if (vals != nullptr) vals[p] = bv;
        ids[p] = bi;
      }
    }
    __syncthreads();
    prev_v = win_v;
    prev_i = win_i;
  }
  return prev_v;
}

}  // namespace
