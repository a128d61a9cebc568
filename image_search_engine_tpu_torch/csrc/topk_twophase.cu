// Two-phase exact top-k for Hopper (sm_90a): the three kernels of the flat
// search, with a plain C interface for ctypes (ops/_kernels.py builds this
// file with nvcc and binds it; ops/topk.py holds the wrappers and the plain
// PyTorch version of each kernel).
//
//   groupmin_kernel  phase 1: for each 128-row group of the store and each
//                    query, min over the group of norms[r] - 2 q.x[r].
//                    Replaces image_search_engine_tpu/ops/topk_pallas.py
//                    _groupmin_kernel.
//   select_kernel    per query, the t smallest group mins in ascending
//                    (value, group id) order. Replaces _select_topt_kernel.
//   rescore_kernel   phase 2: for each (query, candidate group) the 128
//                    scores norms[r] - 2 q.x[r], read in place from the store
//                    (no gather buffer). Replaces _fused_rescore_kernel.
//
// Both scoring kernels compute a row's dot product with one routine
// (row_dot, scoring.cuh): the same lane striding, the same explicit fmaf
// chain and the same butterfly reduction. A phase-1 group min is therefore bit for bit the
// min of the phase-2 scores of that group, so the certificate "k-th final
// score <= t-th selected group min" holds whenever t >= k.
//
// f32 stores are scored in IEEE f32 (fmaf, no TF32). bf16 stores read bf16,
// widen to f32 (exact) and accumulate in f32. Rows at or past n score +inf,
// so the store is never padded or copied per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "scoring.cuh"
#include "select.cuh"

namespace {

constexpr int GROUP = 128;   // candidate-group width (rows)
constexpr int RESCORE_SPLIT = 4;  // phase-2 blocks per candidate group
constexpr int SELECT_MAX_THREADS = 1024;

// Phase 1. Block b handles query tile b % nqt (QT queries) of group b / nqt,
// so the nqt blocks that read one group run back to back and share it in L2.
// Output is query-major: out[qi * ngroups + g].
template <typename T, int VEC, int QT>
__global__ void __launch_bounds__(THREADS)
    groupmin_kernel(const T* __restrict__ q, const float* __restrict__ norms,
                    const T* __restrict__ x, float* __restrict__ out, int nq, long long n, int d,
                    int ngroups, int nqt) {
  extern __shared__ float qs[];  // QT * d
  __shared__ float red[WARPS][QT];
  const int qt = blockIdx.x % nqt;
  const int g = blockIdx.x / nqt;
  const int q0 = qt * QT;
  stage_queries(q, qs, q0, QT, nq, d);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float best[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) best[qi] = INFINITY;
  for (int r = warp; r < GROUP; r += WARPS) {
    const long long row = (long long)g * GROUP + r;
    if (row >= n) break;  // ragged last group: missing rows count as +inf
    float acc[QT];
    row_dot<T, VEC, QT>(x + row * d, qs, d, lane, acc);
    const float nr = __ldg(norms + row);
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) best[qi] = fminf(best[qi], score_of(nr, acc[qi]));
  }
  if (lane == 0) {
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) red[warp][qi] = best[qi];
  }
  __syncthreads();
  if (threadIdx.x < QT && q0 + (int)threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][threadIdx.x]);
    out[(size_t)(q0 + threadIdx.x) * ngroups + g] = m;
  }
}

// Select. One block per query (block_select_topt, select.cuh): t passes, each
// a block-wide argmin over the entries after the previous winner in (value,
// id) order, so ties go to the lowest group id.
__global__ void __launch_bounds__(SELECT_MAX_THREADS)
    select_kernel(const float* __restrict__ mins, float* __restrict__ vals, int* __restrict__ ids,
                  int ngroups, int t) {
  block_select_topt<false>(mins + (size_t)blockIdx.x * ngroups, ngroups, t,
                           vals + (size_t)blockIdx.x * t, ids + (size_t)blockIdx.x * t);
}

// Phase 2. Block b scores rows [s*32, s*32+32) of candidate slot b / SPLIT
// (slot = query * t + j, s = b % SPLIT). out[slot * GROUP + r].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    rescore_kernel(const T* __restrict__ q, const float* __restrict__ norms,
                   const T* __restrict__ x, const int* __restrict__ cand,
                   float* __restrict__ out, long long n, int d, int t) {
  extern __shared__ float qs[];  // d
  constexpr int ROWS = GROUP / RESCORE_SPLIT;
  const int s = blockIdx.x % RESCORE_SPLIT;
  const long long slot = blockIdx.x / RESCORE_SPLIT;
  const int qi = (int)(slot / t);
  stage_queries(q, qs, qi, 1, qi + 1, d);
  __syncthreads();

  const int g = __ldg(cand + slot);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = s * ROWS + warp; r < (s + 1) * ROWS; r += WARPS) {
    const long long row = (long long)g * GROUP + r;
    float score = INFINITY;
    if (g >= 0 && row < n) {
      float acc[1];
      row_dot<T, VEC, 1>(x + row * d, qs, d, lane, acc);
      score = score_of(__ldg(norms + row), acc[0]);
    }
    if (lane == 0) out[slot * GROUP + r] = score;
  }
}

template <typename T, int VEC, int QT>
cudaError_t launch_groupmin(const void* q, const void* norms, const void* x, void* out, int nq,
                            long long n, int d, cudaStream_t stream) {
  const int ngroups = (int)((n + GROUP - 1) / GROUP);
  const int nqt = (nq + QT - 1) / QT;
  const size_t smem = (size_t)QT * d * sizeof(float);
  auto kernel = groupmin_kernel<T, VEC, QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)ngroups * nqt), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(norms), static_cast<const T*>(x),
      static_cast<float*>(out), nq, n, d, ngroups, nqt);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t groupmin_qt(const void* q, const void* norms, const void* x, void* out, int nq,
                        long long n, int d, int qt, cudaStream_t stream) {
  switch (qt) {
    case 1: return launch_groupmin<T, VEC, 1>(q, norms, x, out, nq, n, d, stream);
    case 2: return launch_groupmin<T, VEC, 2>(q, norms, x, out, nq, n, d, stream);
    case 4: return launch_groupmin<T, VEC, 4>(q, norms, x, out, nq, n, d, stream);
    case 8: return launch_groupmin<T, VEC, 8>(q, norms, x, out, nq, n, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
cudaError_t launch_rescore(const void* q, const void* norms, const void* x, const void* cand,
                           void* out, int nq, long long n, int d, int t, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  auto kernel = rescore_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)nq * t * RESCORE_SPLIT), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(norms), static_cast<const T*>(x),
      static_cast<const int*>(cand), static_cast<float*>(out), n, d, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 store, 1 = bfloat16 store. vec: 1, or 16 bytes' worth
// of elements (4 for f32, 8 for bf16) when rows are 16-byte aligned.
// qt: queries per phase-1 block (1, 2, 4 or 8). Every function returns the
// cudaError_t of its launch (0 = success).

int ise_groupmin(int dtype, const void* q, const void* norms, const void* x, void* out, int nq,
                 long long n, int d, int qt, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return groupmin_qt<float, 4>(q, norms, x, out, nq, n, d, qt, s);
  if (dtype == 0 && vec == 1) return groupmin_qt<float, 1>(q, norms, x, out, nq, n, d, qt, s);
  if (dtype == 1 && vec == 8)
    return groupmin_qt<__nv_bfloat16, 8>(q, norms, x, out, nq, n, d, qt, s);
  if (dtype == 1 && vec == 1)
    return groupmin_qt<__nv_bfloat16, 1>(q, norms, x, out, nq, n, d, qt, s);
  return cudaErrorInvalidValue;
}

int ise_select_topt(const void* mins, void* vals, void* ids, int nq, int ngroups, int t,
                    void* stream) {
  int threads = ((ngroups + 31) / 32) * 32;
  if (threads > SELECT_MAX_THREADS) threads = SELECT_MAX_THREADS;
  select_kernel<<<nq, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mins), static_cast<float*>(vals), static_cast<int*>(ids),
      ngroups, t);
  return cudaGetLastError();
}

int ise_rescore(int dtype, const void* q, const void* norms, const void* x, const void* cand,
                void* out, int nq, long long n, int d, int t, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_rescore<float, 4>(q, norms, x, cand, out, nq, n, d, t, s);
  if (dtype == 0 && vec == 1)
    return launch_rescore<float, 1>(q, norms, x, cand, out, nq, n, d, t, s);
  if (dtype == 1 && vec == 8)
    return launch_rescore<__nv_bfloat16, 8>(q, norms, x, cand, out, nq, n, d, t, s);
  if (dtype == 1 && vec == 1)
    return launch_rescore<__nv_bfloat16, 1>(q, norms, x, cand, out, nq, n, d, t, s);
  return cudaErrorInvalidValue;
}

const char* ise_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
