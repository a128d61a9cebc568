// The running top-k's per-warp lists of (score, id) pairs and the kernel
// that merges the slices' lists per query, shared by its two scan kernels:
// topk_running_rows.cu (a lane per row, rows staged in shared memory) and
// topk_running.cu (a warp per row, chip_smoke.py's comparison only).
//
// Order is lexicographic on (score, id), so ties go to the lowest id. Lists
// start as (+inf, -1): every real row beats them, and they are the tail
// when k > N.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "select.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 128;
constexpr int MERGE_THREADS = 1024;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;

// A warp's sorted list of 32 * E (score, id) pairs: position p = e * 32 +
// lane lives in lane `lane`, slot e. Every lane holds the same view of the
// list's order; all 32 lanes call each function together.
template <int E>
__device__ __forceinline__ void list_init(float (&v)[E], int (&id)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = INFINITY;
    id[e] = -1;
  }
}

// The pair at warp-uniform position p, broadcast to every lane.
template <int E>
__device__ __forceinline__ void list_get(const float (&v)[E], const int (&id)[E], int p,
                                         float& ov, int& oi) {
  const int pe = p / 32;
  float sv = v[0];
  int si = id[0];
#pragma unroll
  for (int e = 1; e < E; ++e) {
    if (e == pe) {
      sv = v[e];
      si = id[e];
    }
  }
  ov = __shfl_sync(FULL, sv, p % 32);
  oi = __shfl_sync(FULL, si, p % 32);
}

// Inserts (s, i), keeping the list ascending in (score, id); the last pair
// falls off. Position p keeps its pair if that is less than (s, i), takes (s,
// i) if its predecessor is less (or p = 0), and otherwise takes its
// predecessor's pair.
template <int E>
__device__ __forceinline__ void list_insert(float (&v)[E], int (&id)[E], float s, int i,
                                            int lane) {
  float pv[E];
  int pi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float up_v = __shfl_up_sync(FULL, v[e], 1);
    const int up_i = __shfl_up_sync(FULL, id[e], 1);
    float wrap_v = -INFINITY;
    int wrap_i = -1;
    if (e > 0) {
      wrap_v = __shfl_sync(FULL, v[e > 0 ? e - 1 : 0], 31);
      wrap_i = __shfl_sync(FULL, id[e > 0 ? e - 1 : 0], 31);
    }
    pv[e] = lane > 0 ? up_v : wrap_v;
    pi[e] = lane > 0 ? up_i : wrap_i;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool first = e == 0 && lane == 0;
    if (!lex_less(v[e], id[e], s, i)) {
      if (first || lex_less(pv[e], pi[e], s, i)) {
        v[e] = s;
        id[e] = i;
      } else {
        v[e] = pv[e];
        id[e] = pi[e];
      }
    }
  }
}

// Offers one candidate per lane, (cs, ci); inserts, one at a time, each that
// beats the list's k-th pair (tv, ti), which it keeps up to date.
template <int E>
__device__ __forceinline__ void list_offer(float (&v)[E], int (&id)[E], float& tv, int& ti,
                                           float cs, int ci, int k, int lane) {
  unsigned done = 0;
  unsigned m = __ballot_sync(FULL, lex_less(cs, ci, tv, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    const float s = __shfl_sync(FULL, cs, src);
    const int i = __shfl_sync(FULL, ci, src);
    list_insert<E>(v, id, s, i, lane);
    list_get<E>(v, id, k - 1, tv, ti);
    done |= 1u << src;
    m = __ballot_sync(FULL, lex_less(cs, ci, tv, ti)) & ~done;
  }
}

// Merges `count` (score, id) pairs, read from src_v/src_i at index j for j in
// [0, count) of this warp's share (j = first + 32 * step), into one list.
template <int E>
__device__ __forceinline__ void list_merge_from(float (&v)[E], int (&id)[E], float& tv, int& ti,
                                                const float* src_v, const int* src_i,
                                                long long first, long long count, int stride, int k,
                                                int lane) {
  for (long long c0 = first; c0 < count; c0 += stride) {
    const long long c = c0 + lane;
    float cs = INFINITY;
    int ci = -1;  // never inserted: no list pair is greater than (+inf, -1)
    if (c < count) {
      cs = src_v[c];
      ci = src_i[c];
    }
    list_offer<E>(v, id, tv, ti, cs, ci, k, lane);
  }
}

// Writes the first k pairs of the list to out_v/out_i[0, k).
template <int E>
__device__ __forceinline__ void list_store(const float (&v)[E], const int (&id)[E], float* out_v,
                                           int* out_i, int k, int lane) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    if (p < k) {
      out_v[p] = v[e];
      out_i[p] = id[e];
    }
  }
}

// Block q merges query q's nslices lists: each warp takes a strided share,
// then warp 0 merges the warps' lists.
template <int E>
__global__ void __launch_bounds__(MERGE_THREADS)
    running_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                         float* __restrict__ out_v, int* __restrict__ out_i, int nslices, int k) {
  __shared__ float sv[MERGE_WARPS * MAX_K];
  __shared__ int si[MERGE_WARPS * MAX_K];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long count = (long long)nslices * k;
  const size_t base = (size_t)blockIdx.x * count;
  float v[E];
  int id[E];
  float tv = INFINITY;
  int ti = -1;
  list_init<E>(v, id);
  list_merge_from<E>(v, id, tv, ti, part_v + base, part_i + base, (long long)warp * 32, count,
                     MERGE_THREADS, k, lane);
  list_store<E>(v, id, sv + warp * k, si + warp * k, k, lane);
  __syncthreads();
  if (warp == 0) {
    list_init<E>(v, id);
    tv = INFINITY;
    ti = -1;
    list_merge_from<E>(v, id, tv, ti, sv, si, 0, (long long)MERGE_WARPS * k, 32, k, lane);
    list_store<E>(v, id, out_v + (size_t)blockIdx.x * k, out_i + (size_t)blockIdx.x * k, k, lane);
  }
}

}  // namespace
