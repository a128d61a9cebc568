// Two-phase exact top-k over an int8 store for Hopper (sm_90a), with a plain
// C interface for ctypes (ops/_kernels.py builds this file with nvcc and binds
// it; ops/topk.py holds the wrappers and the plain PyTorch version of each
// kernel). The select between the phases is topk_twophase.cu's.
//
//   groupmin_mma_kernel<int8_t>  phase 1 on the tensor cores
//                       (groupmin_mma.cuh, the bf16 sweep's template), and
//   groupmin_q8_kernel  phase 1 on the CUDA cores for batches of up to 4
//                       queries: for each 128-row group of the store and
//                       each query, min over the group of
//                       norms[r] - f32(q.x[r]) * ((2 qscale) * scales[r]).
//                       Both replace image_search_engine_tpu/ops/
//                       topk_pallas.py _groupmin_kernel_q8.
//   rescore_q8_kernel   phase 2: the same score for the 128 rows of each
//                       (query, candidate group), read in place from the
//                       store. Replaces _fused_rescore_kernel_q8.
//
// Bound: phase 1 streams the store once, N * d code bytes plus 8 bytes of
// norm and scale per row, and does 2 * Q * N * d integer operations: bytes
// bound it at serving batch sizes, operations at large Q (1,979 TOP/s on the
// int8 tensor cores, far past the CUDA cores' __dp4a rate). So phase 1
// multiplies with mma.sync m16n8k32 into exact s32 sums on the tensor cores,
// query tiles of up to 128 against slices of the store streamed through
// shared memory, d zero-padded to 32 codes. Up to 4 queries, where only the
// store's bytes count, the CUDA-core sweep streams it closer to the memory
// rate (its warps read whole rows; the tile sweep reads 256-byte column
// slices of 128 rows), so the wrapper keeps it there. Phase 2 reads t
// scattered groups per query, a few dozen at Q = 1, and stays on the CUDA
// cores. The CUDA-core kernels read 16 codes per 16-byte load and multiply
// them with __dp4a (row_dot_q8, scoring.cuh; a scalar loop takes rows that
// are not 16-byte multiples). Integer sums are exact in any order and the
// padding adds 0, so every kernel gives the same int32 for a row, and all
// run the same f32 epilogue (score_q8, rounded step by step in the plain
// version's order): each kernel equals its plain version bit for bit, and a
// phase-1 group min is the min of its phase-2 scores, which keeps the
// certificate valid whenever t >= k. Rows at or past n score +inf, so the
// store is never padded or copied per call.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "scoring.cuh"

namespace {

constexpr int RESCORE_SPLIT = 4;  // phase-2 blocks per candidate group

// Phase 1 at small batches, on CUDA cores. Block b handles query tile b %
// nqt (QT queries) of group b / nqt, so the nqt blocks that read one group
// run back to back and share it in L2; each warp reads whole rows with
// 16-byte loads. Output is query-major: out[qi * ngroups + g].
template <int VEC, int QT>
__global__ void __launch_bounds__(THREADS)
    groupmin_q8_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
                       const float* __restrict__ norms, const float* __restrict__ scales,
                       const int8_t* __restrict__ x, float* __restrict__ out, int nq,
                       long long n, int d, int ngroups, int nqt) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem);  // QT * d codes
  __shared__ float qs2[QT];
  __shared__ float red[WARPS][QT];
  const int qt = blockIdx.x % nqt;
  const int g = blockIdx.x / nqt;
  const int q0 = qt * QT;
  stage_queries_q8<VEC>(q, qs, q0, QT, nq, d);
  if (threadIdx.x < QT)
    qs2[threadIdx.x] = q0 + (int)threadIdx.x < nq ? __fmul_rn(2.f, qscale[q0 + threadIdx.x]) : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float best[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) best[qi] = INFINITY;
  for (int r = warp; r < GROUP; r += WARPS) {
    const long long row = (long long)g * GROUP + r;
    if (row >= n) break;  // ragged last group: missing rows count as +inf
    int acc[QT];
    row_dot_q8<VEC, QT>(x + row * d, qs, d, lane, acc);
    const float nr = __ldg(norms + row);
    const float sc = __ldg(scales + row);
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) best[qi] = fminf(best[qi], score_q8(nr, acc[qi], qs2[qi], sc));
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

// Phase 2. Block b scores rows [s*32, s*32+32) of candidate slot b / SPLIT
// (slot = query * t + j, s = b % SPLIT). out[slot * GROUP + r].
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    rescore_q8_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
                      const float* __restrict__ norms, const float* __restrict__ scales,
                      const int8_t* __restrict__ x, const int* __restrict__ cand,
                      float* __restrict__ out, long long n, int d, int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem);  // d codes
  constexpr int ROWS = GROUP / RESCORE_SPLIT;
  const int s = blockIdx.x % RESCORE_SPLIT;
  const long long slot = blockIdx.x / RESCORE_SPLIT;
  const int qi = (int)(slot / t);
  stage_queries_q8<VEC>(q, qs, qi, 1, qi + 1, d);
  __syncthreads();

  const float qs2 = __fmul_rn(2.f, __ldg(qscale + qi));
  const int g = __ldg(cand + slot);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = s * ROWS + warp; r < (s + 1) * ROWS; r += WARPS) {
    const long long row = (long long)g * GROUP + r;
    float score = INFINITY;
    if (g >= 0 && row < n) {
      int acc[1];
      row_dot_q8<VEC, 1>(x + row * d, qs, d, lane, acc);
      score = score_q8(__ldg(norms + row), acc[0], qs2, __ldg(scales + row));
    }
    if (lane == 0) out[slot * GROUP + r] = score;
  }
}

template <int VEC, int QT>
cudaError_t launch_groupmin_q8(const void* q, const void* qscale, const void* norms,
                               const void* scales, const void* x, void* out, int nq, long long n,
                               int d, cudaStream_t stream) {
  const int ngroups = (int)((n + GROUP - 1) / GROUP);
  const int nqt = (nq + QT - 1) / QT;
  const size_t smem = (size_t)QT * d;
  auto kernel = groupmin_q8_kernel<VEC, QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)ngroups * nqt), THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qscale),
      static_cast<const float*>(norms), static_cast<const float*>(scales),
      static_cast<const int8_t*>(x), static_cast<float*>(out), nq, n, d, ngroups, nqt);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t groupmin_q8_qt(const void* q, const void* qscale, const void* norms, const void* scales,
                           const void* x, void* out, int nq, long long n, int d, int qt,
                           cudaStream_t s) {
  switch (qt) {
    case 1: return launch_groupmin_q8<VEC, 1>(q, qscale, norms, scales, x, out, nq, n, d, s);
    case 2: return launch_groupmin_q8<VEC, 2>(q, qscale, norms, scales, x, out, nq, n, d, s);
    case 4: return launch_groupmin_q8<VEC, 4>(q, qscale, norms, scales, x, out, nq, n, d, s);
    case 8: return launch_groupmin_q8<VEC, 8>(q, qscale, norms, scales, x, out, nq, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int VEC>
cudaError_t launch_rescore_q8(const void* q, const void* qscale, const void* norms,
                              const void* scales, const void* x, const void* cand, void* out,
                              int nq, long long n, int d, int t, cudaStream_t stream) {
  const size_t smem = (size_t)d;
  auto kernel = rescore_q8_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)nq * t * RESCORE_SPLIT), THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qscale),
      static_cast<const float*>(norms), static_cast<const float*>(scales),
      static_cast<const int8_t*>(x), static_cast<const int*>(cand), static_cast<float*>(out), n,
      d, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (nq, d) int8 query codes; qscale: (nq,) f32 query scales (halved for ip);
// norms, scales: (n,) f32; x: (n, d) int8 store codes. Every function returns
// the cudaError_t of its launch (0 = success).

// Phase 1 at small batches. vec: 16 when store and query rows are 16-byte
// aligned, else 1. qt: queries per block (1, 2, 4 or 8).
int ise_groupmin_q8(const void* q, const void* qscale, const void* norms, const void* scales,
                    const void* x, void* out, int nq, long long n, int d, int qt, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16) return groupmin_q8_qt<16>(q, qscale, norms, scales, x, out, nq, n, d, qt, s);
  if (vec == 1) return groupmin_q8_qt<1>(q, qscale, norms, scales, x, out, nq, n, d, qt, s);
  return cudaErrorInvalidValue;
}

// Phase 1 on the tile plan of ops/topk.py mma_plan(..., itemsize=1): bq, dp
// and kc (codes), gps, resident and smem as for ise_groupmin_mma; vec: codes
// per copy, 16, 4 or 1.
int ise_groupmin_q8_mma(const void* q, const void* qscale, const void* norms, const void* scales,
                        const void* x, void* out, int nq, long long n, int d, int bq, int dp,
                        int kc, int gps, int resident, int smem, int vec, void* stream) {
  return groupmin_mma<int8_t>(q, qscale, norms, scales, x, out, nq, n, d, bq, dp, kc, gps,
                              resident, smem, vec, static_cast<cudaStream_t>(stream));
}

// Phase 2. vec: 16 when store and query rows are 16-byte aligned, else 1.
int ise_rescore_q8(const void* q, const void* qscale, const void* norms, const void* scales,
                   const void* x, const void* cand, void* out, int nq, long long n, int d, int t,
                   int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    return launch_rescore_q8<16>(q, qscale, norms, scales, x, cand, out, nq, n, d, t, s);
  if (vec == 1)
    return launch_rescore_q8<1>(q, qscale, norms, scales, x, cand, out, nq, n, d, t, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
