// The running top-k's first Hopper kernels (sm_90a), a warp per row, with a
// plain C interface for ctypes (ops/_kernels.py builds this file with nvcc
// and binds it). ops/topk.py topk_running launches them only on the
// "row_dot" route (RUNNING_ROUTE), which chip_smoke.py alone takes, to time
// them beside the kernel that replaced them (topk_running_rows.cu, a lane
// per row over rows staged in shared memory, where the design of both is
// described).
//
//   running_scan_kernel   block (slice, query tile) scores one contiguous
//                         slice of the store against up to 8 queries staged
//                         as f32 in shared memory, a warp per row: each lane
//                         reads 16 bytes of the row and, for each of them,
//                         QT x 16 bytes of the query tile from shared memory,
//                         and a butterfly of shuffles per query sums the row.
//                         Each warp keeps, per query, its own running top-k
//                         (running_lists.cuh) and inserts a row only when it
//                         beats the warp's k-th. At the end the block merges
//                         its warps' lists into one list per query, in a (Q,
//                         slices, k) scratch.
//   running_merge_kernel  one block per query merges the slices' lists into
//                         the final top-k (running_lists.cuh).
//
// Its bound is the store's bytes, but at Q = 8 the query reads from shared
// memory (QT floats for every store float, on the store loads' pipe) and the
// 8 five-step butterflies a row held it at less than half of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "running_lists.cuh"
#include "scoring.cuh"

namespace {

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
