// Two-phase exact top-k for Hopper (sm_90a): the kernels of the flat search,
// with a plain C interface for ctypes (ops/_kernels.py builds this file with
// nvcc and binds it; ops/topk.py holds the wrappers and the plain PyTorch
// version of each kernel).
//
//   groupmin_kernel      phase 1, f32 store (small batches, or rows of no
//                        whole 16-byte units): for each 128-row group of
//                        the store and each query, min over the group of
//                        norms[r] - 2 q.x[r] on CUDA cores.
//   groupmin_mma_kernel  phase 1, bf16 store: the same mins from a tiled
//                        tensor-core sweep (groupmin_mma.cuh, shared with
//                        the int8 store). Both replace
//                        image_search_engine_tpu/ops/topk_pallas.py
//                        _groupmin_kernel.
//   select_kernel        per query, the t smallest group mins in ascending
//                        (value, group id) order by t extract-min passes,
//                        the TPU kernel's algorithm. No search path
//                        launches it: select_topt.cu's radix select, which
//                        replaced it for every t, is timed beside it by
//                        chip_smoke.py. Both replace _select_topt_kernel.
//   rescore_kernel       phase 2, f32 store (as groupmin_kernel): for each
//                        (query, candidate group) the 128 scores norms[r] -
//                        2 q.x[r], read in place from the store (no gather
//                        buffer).
//   rescore_mma_kernel   phase 2, bf16 store: the same on tensor cores. Both
//                        replace _fused_rescore_kernel.
//
// An f32 store's batches beyond a few queries over rows of whole 16-byte
// units take both phases on the warpgroup MMA instead (groupmin_tf32.cu;
// ops/topk.py picks the route, the same for both phases). Phase 1 and phase
// 2 score a row with one routine per store dtype and route: f32 here with
// row_dot (scoring.cuh: the same lane striding, the same explicit fmaf
// chain and the same butterfly reduction), bf16 with mma_steps
// (mma.cuh: the same lane, register and mma sequence for every score).
// A phase-1 group min is therefore bit for bit the min of the phase-2 scores
// of that group, so the certificate "k-th final score <= t-th selected group
// min" holds whenever t >= k.
//
// f32 stores are scored here in IEEE f32 (fmaf, no TF32); groupmin_tf32.cu
// scores them with a 3xTF32 split, the counterpart of the JAX package's
// Precision.HIGHEST. bf16 stores multiply bf16 by bf16 (exact in f32) and
// accumulate in f32 on the tensor cores.
// Rows at or past n score +inf, so the store is never padded or copied per
// call. The f32 phase-1 and phase-2 blocks and the bf16 phase-2 block are
// twophase.cuh's routines, which the merged search (topk_merged.cu) runs
// too; each kernel here calls its routine with blockIdx.x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "mma.cuh"
#include "scoring.cuh"
#include "select.cuh"
#include "twophase.cuh"

namespace {

constexpr int SELECT_MAX_THREADS = 1024;

// Phase 1 (twophase.cuh groupmin_block): block b takes query tile b % nqt of
// group b / nqt.
template <typename T, int VEC, int QT>
__global__ void __launch_bounds__(THREADS)
    groupmin_kernel(const T* __restrict__ q, const float* __restrict__ norms,
                    const T* __restrict__ x, float* __restrict__ out, int nq, long long n, int d,
                    int ngroups, int nqt) {
  groupmin_block<T, VEC, QT>(q, norms, x, out, nq, n, d, ngroups, nqt, blockIdx.x);
}

// Select, the extract-min route (chip_smoke.py's comparison). One block per query
// (block_select_topt, select.cuh): t passes, each a block-wide argmin over
// the entries after the previous winner in (value, id) order, so ties go to
// the lowest group id.
__global__ void __launch_bounds__(SELECT_MAX_THREADS)
    select_kernel(const float* __restrict__ mins, float* __restrict__ vals, int* __restrict__ ids,
                  int ngroups, int t) {
  block_select_topt(mins + (size_t)blockIdx.x * ngroups, ngroups, t,
                    vals + (size_t)blockIdx.x * t, ids + (size_t)blockIdx.x * t);
}

// Phase 2 (twophase.cuh rescore_block): block b takes rows [s*32, s*32+32)
// of candidate slot b / SPLIT, its group read from cand.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    rescore_kernel(const T* __restrict__ q, const float* __restrict__ norms,
                   const T* __restrict__ x, const int* __restrict__ cand,
                   float* __restrict__ out, long long n, int d, int t) {
  rescore_block<T, VEC>(q, norms, x, out, n, d, t, blockIdx.x,
                        [cand](long long slot) { return __ldg(cand + slot); });
}

// Phase 2 for a bf16 store on tensor cores (twophase.cuh rescore_mma_block):
// block b scores the (query, candidate group) pair of slot b on its
// RESCORE_MMA_WARPS warps.
template <int VEC>
__global__ void __launch_bounds__(RESCORE_MMA_WARPS * 32)
    rescore_mma_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ norms,
                       const __nv_bfloat16* __restrict__ x, const int* __restrict__ cand,
                       float* __restrict__ out, long long n, int d, int dp, int kc, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  rescore_mma_block<VEC, BlockThreads>(q, norms, x, out, n, d, dp, kc, t, smem,
                                       [] { return (long long)blockIdx.x; },
                                       [cand](long long slot) { return __ldg(cand + slot); });
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

template <int VEC>
cudaError_t launch_rescore_mma(const void* q, const void* norms, const void* x, const void* cand,
                               void* out, int nq, long long n, int d, int t, int dp, int kc,
                               size_t smem, cudaStream_t stream) {
  const long long grid = (long long)nq * t;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = rescore_mma_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, RESCORE_MMA_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(norms),
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(cand),
      static_cast<float*>(out), n, d, dp, kc, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The f32 store's phase 1 and 2 (CUDA cores). vec: 1, or 4 when rows are
// 16-byte aligned. qt: queries per phase-1 block (1, 2, 4 or 8). Every
// function returns the cudaError_t of its launch (0 = success).

int ise_groupmin(const void* q, const void* norms, const void* x, void* out, int nq, long long n,
                 int d, int qt, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return groupmin_qt<float, 4>(q, norms, x, out, nq, n, d, qt, s);
  if (vec == 1) return groupmin_qt<float, 1>(q, norms, x, out, nq, n, d, qt, s);
  return cudaErrorInvalidValue;
}

// The bf16 store's phase 1 and 2 (tensor cores), on the tile plan of
// ops/topk.py mma_plan: bq queries per block (16, 32, 64 or 128), dp the
// padded d, kc the k-chunk, gps groups per block, resident 1 to keep the
// query tile in shared memory (0: stream it beside the store), smem the
// dynamic shared memory. vec: bf16 elements per copy, 8 (16-byte aligned
// rows), 2 (4-byte) or 1.

int ise_groupmin_mma(const void* q, const void* norms, const void* x, void* out, int nq,
                     long long n, int d, int bq, int dp, int kc, int gps, int resident, int smem,
                     int vec, void* stream) {
  return groupmin_mma<__nv_bfloat16>(q, nullptr, norms, nullptr, x, out, nq, n, d, bq, dp, kc,
                                     gps, resident, smem, vec, static_cast<cudaStream_t>(stream));
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

int ise_rescore(const void* q, const void* norms, const void* x, const void* cand, void* out,
                int nq, long long n, int d, int t, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return launch_rescore<float, 4>(q, norms, x, cand, out, nq, n, d, t, s);
  if (vec == 1) return launch_rescore<float, 1>(q, norms, x, cand, out, nq, n, d, t, s);
  return cudaErrorInvalidValue;
}

int ise_rescore_mma(const void* q, const void* norms, const void* x, const void* cand, void* out,
                    int nq, long long n, int d, int t, int dp, int kc, int smem, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mma_plan_ok(d, dp, kc, MMA_KBYTES / 2, (size_t)smem, rescore_mma_smem(dp, kc)))
    return cudaErrorInvalidValue;
  if (vec == 8)
    return launch_rescore_mma<8>(q, norms, x, cand, out, nq, n, d, t, dp, kc, smem, s);
  if (vec == 2)
    return launch_rescore_mma<2>(q, norms, x, cand, out, nq, n, d, t, dp, kc, smem, s);
  if (vec == 1)
    return launch_rescore_mma<1>(q, norms, x, cand, out, nq, n, d, t, dp, kc, smem, s);
  return cudaErrorInvalidValue;
}

const char* ise_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
