// Merged two-phase exact top-k for Hopper (sm_90a): group-min sweep, select
// and candidate rescore in ONE cooperative launch, with a plain C interface
// for ctypes (ops/_kernels.py builds this file with nvcc and binds it;
// ops/topk_merged.py holds the wrapper, merged_candidates, its plain PyTorch
// version and the search, topk_merged).
//
// Replaces image_search_engine_tpu/ops/topk_merged.py _merged_kernel (via
// topk_merged). The TPU kernel is one program so that query block b's
// candidate copies overlap block b+1's sweep, which separate programs cannot
// do on a TPU core. Here the grid is launched cooperatively (every block
// resident at once, sized by the occupancy calculator) and runs three
// stages separated by grid-wide barriers:
//
//   1. group mins: for each 128-row group and each query tile, the min of
//      norms[r] - 2 q.x[r] into a (Q, ngroups) scratch, in groupmin_kernel's
//      work order (the query tiles of one group back to back, so they share
//      it in L2);
//   2. select: per query, the t smallest group mins in ascending (value,
//      group id) order (block_select_topt, select.cuh, as select_kernel) and
//      the t-th as the certificate threshold; when t = ngroups every group is
//      a candidate, in order, and the threshold is +inf;
//   3. rescore: every row of each query's t groups, in rescore_kernel's
//      order (each group split over 4 work items of 32 rows).
//
// Each stage is a grid-stride loop over the same work items as the
// three-kernel search's f32 kernels (topk_twophase.cu) and scores rows with
// the same routine (scoring.cuh's row_dot and score_of, the same VEC), so
// over an f32 store this search equals topk_twophase at the same margin bit
// for bit wherever topk_twophase scores f32 on CUDA cores (a few queries,
// ops/topk.py F32_CUDA_CORE_MAX_Q): the same mins, the same candidate
// groups in the same order, the same scores. Over a bf16 store, and over an
// f32 one beyond those few queries, topk_twophase scores on tensor cores
// (mma.cuh, groupmin_tf32.cu) while this search keeps row_dot: the two
// agree within the f32 summation-order tolerance.
//
// What bounds it: as the two-phase search, one read of the store per query
// tile (bytes at small Q; the 2*Q*N*d operations at large Q), then the
// gathered candidate rows. What one launch saves is two launches and their
// gaps. The stages run in sequence: overlapping one query block's rescore
// with the next block's sweep (the point of the TPU design) is later work,
// with warp specialisation and TMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "scoring.cuh"
#include "select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP = 128;        // candidate-group width (rows)
constexpr int RESCORE_SPLIT = 4;  // stage-3 work items per candidate group

// mins (Q, ngroups), cand (Q, t) and thr (Q,) are written by one stage and
// read by the next through L2 (__ldcg), never through the read-only cache.
template <typename T, int VEC, int QT>
__global__ void __launch_bounds__(THREADS)
    merged_kernel(const T* __restrict__ q, const float* __restrict__ norms,
                  const T* __restrict__ x, float* mins, int* cand, float* thr,
                  float* __restrict__ scores, int nq, long long n, int d, int ngroups, int t) {
  extern __shared__ float qs[];  // QT * d in stage 1, d in stage 3
  __shared__ float red[WARPS][QT];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- stage 1: group mins; item = g * nqt + query tile ----
  const int nqt = (nq + QT - 1) / QT;
  int staged = -1;
  for (long long item = blockIdx.x; item < (long long)ngroups * nqt; item += gridDim.x) {
    const int qt = (int)(item % nqt);
    const int g = (int)(item / nqt);
    const int q0 = qt * QT;
    if (qt != staged) {
      __syncthreads();
      stage_queries(q, qs, q0, QT, nq, d);
      __syncthreads();
      staged = qt;
    }
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
      mins[(size_t)(q0 + threadIdx.x) * ngroups + g] = m;
    }
    __syncthreads();  // red is rewritten by the next item
  }
  grid.sync();

  // ---- stage 2: select, one query per block ----
  for (int qi = blockIdx.x; qi < nq; qi += gridDim.x) {
    int* ids = cand + (size_t)qi * t;
    if (t == ngroups) {
      for (int j = threadIdx.x; j < t; j += blockDim.x) ids[j] = j;
      if (threadIdx.x == 0) thr[qi] = INFINITY;
    } else {
      const float last =
          block_select_topt<true>(mins + (size_t)qi * ngroups, ngroups, t, nullptr, ids);
      if (threadIdx.x == 0) thr[qi] = last;
    }
  }
  grid.sync();

  // ---- stage 3: rescore; item = (query * t + j) * SPLIT + s ----
  constexpr int ROWS = GROUP / RESCORE_SPLIT;
  staged = -1;
  for (long long item = blockIdx.x; item < (long long)nq * t * RESCORE_SPLIT; item += gridDim.x) {
    const int s = (int)(item % RESCORE_SPLIT);
    const long long slot = item / RESCORE_SPLIT;
    const int qi = (int)(slot / t);
    if (qi != staged) {
      __syncthreads();
      stage_queries(q, qs, qi, 1, qi + 1, d);
      __syncthreads();
      staged = qi;
    }
    const int g = __ldcg(cand + slot);
    for (int r = s * ROWS + warp; r < (s + 1) * ROWS; r += WARPS) {
      const long long row = (long long)g * GROUP + r;
      float score = INFINITY;
      if (g >= 0 && row < n) {
        float acc[1];
        row_dot<T, VEC, 1>(x + row * d, qs, d, lane, acc);
        score = score_of(__ldg(norms + row), acc[0]);
      }
      if (lane == 0) scores[slot * GROUP + r] = score;
    }
  }
}

template <typename T, int VEC, int QT>
cudaError_t launch_merged(const void* q, const void* norms, const void* x, void* mins, void* cand,
                          void* thr, void* scores, int nq, long long n, int d, int t,
                          cudaStream_t stream) {
  auto kernel = merged_kernel<T, VEC, QT>;
  const size_t smem = (size_t)QT * d * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;  // not even one block fits an SM
  const T* q_ = static_cast<const T*>(q);
  const float* norms_ = static_cast<const float*>(norms);
  const T* x_ = static_cast<const T*>(x);
  float* mins_ = static_cast<float*>(mins);
  int* cand_ = static_cast<int*>(cand);
  float* thr_ = static_cast<float*>(thr);
  float* scores_ = static_cast<float*>(scores);
  int ngroups = (int)((n + GROUP - 1) / GROUP);
  void* args[] = {&q_, &norms_, &x_, &mins_, &cand_, &thr_, &scores_, &nq, &n, &d, &ngroups, &t};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t merged_qt(const void* q, const void* norms, const void* x, void* mins, void* cand,
                      void* thr, void* scores, int nq, long long n, int d, int qt, int t,
                      cudaStream_t s) {
  switch (qt) {
    case 1: return launch_merged<T, VEC, 1>(q, norms, x, mins, cand, thr, scores, nq, n, d, t, s);
    case 2: return launch_merged<T, VEC, 2>(q, norms, x, mins, cand, thr, scores, nq, n, d, t, s);
    case 4: return launch_merged<T, VEC, 4>(q, norms, x, mins, cand, thr, scores, nq, n, d, t, s);
    case 8: return launch_merged<T, VEC, 8>(q, norms, x, mins, cand, thr, scores, nq, n, d, t, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 store, 1 = bfloat16 store; q is in the store dtype. vec:
// 1, or 16 bytes' worth of elements (4 for f32, 8 for bf16) when rows are
// 16-byte aligned. qt: queries per stage-1 work item (1, 2, 4 or 8). mins:
// (nq, ngroups) scratch; cand (nq, t) int32 and thr (nq,) f32: the selected
// groups and the certificate threshold; scores (nq, t * 128) f32, column j *
// 128 + i for row cand[:, j] * 128 + i (+inf past n). 0 < t <= ngroups.
// Returns the cudaError_t of the one cooperative launch (0 = success).
int ise_topk_merged(int dtype, const void* q, const void* norms, const void* x, void* mins,
                    void* cand, void* thr, void* scores, int nq, long long n, int d, int qt, int t,
                    int vec, void* stream) {
  const long long ngroups = (n + GROUP - 1) / GROUP;
  if (t < 1 || t > ngroups || ngroups > INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return merged_qt<float, 4>(q, norms, x, mins, cand, thr, scores, nq, n, d, qt, t, s);
  if (dtype == 0 && vec == 1)
    return merged_qt<float, 1>(q, norms, x, mins, cand, thr, scores, nq, n, d, qt, t, s);
  if (dtype == 1 && vec == 8)
    return merged_qt<__nv_bfloat16, 8>(q, norms, x, mins, cand, thr, scores, nq, n, d, qt, t, s);
  if (dtype == 1 && vec == 1)
    return merged_qt<__nv_bfloat16, 1>(q, norms, x, mins, cand, thr, scores, nq, n, d, qt, t, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
