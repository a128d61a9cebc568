// Exact top-k with running accumulators for Hopper (sm_90a), with a plain C
// interface for ctypes (ops/_kernels.py builds this file with nvcc and binds
// it; ops/topk.py holds the wrapper, topk_running, and its plain PyTorch
// version, topk_running_ref).
//
// Replaces image_search_engine_tpu/ops/topk_pallas.py _topk_kernel (via
// topk_pallas). There one TPU core walks the store tile by tile, keeps a (Q,
// k) accumulator in VMEM scratch across the sequential grid, and merges a
// tile only when its row min beats some query's k-th. Here blocks run in
// parallel and in no order, so the accumulator is split and merged twice:
//
//   running_scan_kernel   block (slice, query tile) scores one contiguous
//                         slice of the store against up to 8 queries staged
//                         as f32 in shared memory. Each warp keeps, per
//                         query, its own running top-k of (score, id) pairs in
//                         registers, sorted and spread over the lanes; a row
//                         is inserted only when it beats the warp's current
//                         k-th (the TPU kernel's reject-fast test, per row).
//                         A warp owns its lists, so there is no shared list to
//                         contend on and no atomic. At the end the block
//                         merges its warps' lists into one list per query, in
//                         a (Q, slices, k) scratch.
//   running_merge_kernel  one block per query merges the slices' lists into
//                         the final top-k.
//
// Order is lexicographic on (score, id), so ties go to the lowest id, as the
// TPU kernel's min/argmin passes give. Lists start as (+inf, -1): every real
// row beats them, and they are the tail when k > N.
//
// What bounds it on the card: one read of the store per query tile, N*d*
// itemsize + 4N bytes. At Q <= 8 its 2*Q*N*d f32 operations are far below the
// card's rate, so, like groupmin, it is a memory-bandwidth kernel. Rows are
// scored by scoring.cuh's row_dot (16-byte loads, one explicit fmaf chain);
// the query stays f32 over a bf16 store, as the TPU wrapper widens both sides
// to f32, and bf16 rows are widened in registers (no f32 copy of the store).
// The grid holds a few blocks per SM, so each block streams a long slice and
// the partial lists stay small next to the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "scoring.cuh"
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

// Block (slice, query tile): rows [slice * rows_per_slice, ...) against
// queries [tile * QT, ...). part_v/part_i[(q * nslices + slice) * k + p].
template <typename T, int VEC, int QT, int E>
__global__ void __launch_bounds__(THREADS)
    running_scan_kernel(const float* __restrict__ q, const float* __restrict__ norms,
                        const T* __restrict__ x, float* __restrict__ part_v,
                        int* __restrict__ part_i, int nq, long long n, int d, int k, int nslices,
                        long long rows_per_slice) {
  extern __shared__ float smem[];  // the query tile, then the warps' lists
  const int slice = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  stage_queries(q, smem, q0, QT, nq, d);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float v[QT][E];
  int id[QT][E];
  float tv[QT];
  int ti[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    list_init<E>(v[qi], id[qi]);
    tv[qi] = INFINITY;
    ti[qi] = -1;
  }
  const long long r0 = (long long)slice * rows_per_slice;
  const long long r1 = r0 + rows_per_slice < n ? r0 + rows_per_slice : n;
  for (long long row = r0 + warp; row < r1; row += WARPS) {
    float acc[QT];
    row_dot<T, VEC, QT>(x + row * d, smem, d, lane, acc);
    const float nr = __ldg(norms + row);
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      // every lane holds the same sum, so the branch is warp-uniform; rows
      // come in increasing id order, so a tie with the k-th is rejected
      const float s = score_of(nr, acc[qi]);
      if (q0 + qi < nq && lex_less(s, (int)row, tv[qi], ti[qi])) {
        list_insert<E>(v[qi], id[qi], s, (int)row, lane);
        list_get<E>(v[qi], id[qi], k - 1, tv[qi], ti[qi]);
      }
    }
  }

  __syncthreads();  // the query tile is dead: its memory holds the lists now
  float* lv = smem;                                      // [WARPS][QT][k]
  int* li = reinterpret_cast<int*>(smem + WARPS * QT * k);  // the same, ids
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    const size_t at = (size_t)(warp * QT + qi) * k;
    list_store<E>(v[qi], id[qi], lv + at, li + at, k, lane);
  }
  __syncthreads();
  // warp w merges query w's WARPS lists (pairs [w * k, w * k + k) of each)
  if (warp < QT && q0 + warp < nq) {
    float mv[E];
    int mi[E];
    float mtv = INFINITY;
    int mti = -1;
    list_init<E>(mv, mi);
    for (int w = 0; w < WARPS; ++w) {
      const size_t at = (size_t)(w * QT + warp) * k;
      list_merge_from<E>(mv, mi, mtv, mti, lv + at, li + at, 0, k, 32, k, lane);
    }
    const size_t out = ((size_t)(q0 + warp) * nslices + slice) * k;
    list_store<E>(mv, mi, part_v + out, part_i + out, k, lane);
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

template <typename T, int VEC, int QT, int E>
cudaError_t launch_running(const void* q, const void* norms, const void* x, void* part_v,
                           void* part_i, void* out_v, void* out_i, int nq, long long n, int d,
                           int k, int nslices, cudaStream_t stream) {
  const int nqt = (nq + QT - 1) / QT;
  const long long rows_per_slice = (n + nslices - 1) / nslices;
  const size_t tile = (size_t)QT * d * sizeof(float);
  const size_t lists = (size_t)WARPS * QT * k * (sizeof(float) + sizeof(int));
  const size_t smem = tile > lists ? tile : lists;
  auto scan = running_scan_kernel<T, VEC, QT, E>;
  cudaError_t err =
      cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scan<<<dim3((unsigned)nslices, (unsigned)nqt), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(norms), static_cast<const T*>(x),
      static_cast<float*>(part_v), static_cast<int*>(part_i), nq, n, d, k, nslices,
      rows_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  running_merge_kernel<E><<<nq, MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), nslices, k);
  return cudaGetLastError();
}

template <typename T, int VEC, int QT>
cudaError_t running_k(const void* q, const void* norms, const void* x, void* part_v, void* part_i,
                      void* out_v, void* out_i, int nq, long long n, int d, int k, int nslices,
                      cudaStream_t s) {
  if (k <= 32)
    return launch_running<T, VEC, QT, 1>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k,
                                         nslices, s);
  if (k <= 64)
    return launch_running<T, VEC, QT, 2>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k,
                                         nslices, s);
  return launch_running<T, VEC, QT, 4>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k,
                                       nslices, s);
}

template <typename T, int VEC>
cudaError_t running_qt(const void* q, const void* norms, const void* x, void* part_v,
                       void* part_i, void* out_v, void* out_i, int nq, long long n, int d, int k,
                       int qt, int nslices, cudaStream_t s) {
#define ISE_RUNNING_QT(QT) \
  running_k<T, VEC, QT>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k, nslices, s)
  switch (qt) {
    case 1: return ISE_RUNNING_QT(1);
    case 2: return ISE_RUNNING_QT(2);
    case 4: return ISE_RUNNING_QT(4);
    case 8: return ISE_RUNNING_QT(8);
    default: return cudaErrorInvalidValue;
  }
#undef ISE_RUNNING_QT
}

}  // namespace

extern "C" {

// dtype: 0 = float32 store, 1 = bfloat16 store; the query q is float32 either
// way. vec: 1, or 16 bytes' worth of store elements (4 for f32, 8 for bf16)
// when rows are 16-byte aligned. qt: queries per scan block (1, 2, 4 or 8).
// part_v/part_i: (nq, nslices, k) scratch; out_v/out_i: (nq, k), ascending in
// (score, id). 1 <= k <= 128, 1 <= nslices, n < 2^31. Returns the cudaError_t
// of the two launches (0 = success).
int ise_topk_running(int dtype, const void* q, const void* norms, const void* x, void* part_v,
                     void* part_i, void* out_v, void* out_i, int nq, long long n, int d, int k,
                     int qt, int nslices, int vec, void* stream) {
  if (k < 1 || k > MAX_K || nslices < 1 || n >= INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISE_RUNNING(T, VEC) \
  running_qt<T, VEC>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k, qt, nslices, s)
  if (dtype == 0 && vec == 4) return ISE_RUNNING(float, 4);
  if (dtype == 0 && vec == 1) return ISE_RUNNING(float, 1);
  if (dtype == 1 && vec == 8) return ISE_RUNNING(__nv_bfloat16, 8);
  if (dtype == 1 && vec == 1) return ISE_RUNNING(__nv_bfloat16, 1);
  return cudaErrorInvalidValue;
#undef ISE_RUNNING
}

}  // extern "C"
