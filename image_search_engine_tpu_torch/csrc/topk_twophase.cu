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
//                        (value, group id) order by t extract-min passes:
//                        the select's route for t beyond select_topt.cu's
//                        one-pass radix select (ops/topk.py
//                        SELECT_RADIX_MAX_T). Both replace
//                        _select_topt_kernel.
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
// call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "mma.cuh"
#include "scoring.cuh"
#include "select.cuh"

namespace {

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

// Select, the extract-min route (large t). One block per query
// (block_select_topt, select.cuh): t passes, each a block-wide argmin over
// the entries after the previous winner in (value, id) order, so ties go to
// the lowest group id.
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

// Phase 2 for a bf16 store on tensor cores. Block b scores the (query,
// candidate group) pair of slot b; its 4 warps take 32 of the group's rows
// each. The query sits in A row (query % 16), every other A row is zero
// (those lanes read a zero row), and the group's row r sits in column r %
// 32 of warp r / 32: the same lane and register of an 8-row B tile as phase
// 1 gives it, and every score runs the same mma sequence over the whole of
// d. The query row and the zero row are staged once per block; each warp
// streams its 32 rows in k-chunks of kc columns, cp.async double-buffered
// in its own two stages (four warps keep four chunks of a pair in flight,
// where a single warp would stream all 128 rows in one chain of dependent
// chunks). out[slot * GROUP + r], +inf for rows at or past n.
constexpr int RESCORE_MMA_WARPS = 4;
constexpr int RESCORE_MMA_ROWS = GROUP / RESCORE_MMA_WARPS;  // rows per warp

__host__ __device__ inline size_t rescore_mma_smem(int dp, int kc) {
  return (size_t)2 * (dp * 2 + SMEM_PAD_BYTES) +
         (size_t)RESCORE_MMA_WARPS * 2 * RESCORE_MMA_ROWS * (kc * 2 + SMEM_PAD_BYTES);
}

template <int VEC>
__global__ void __launch_bounds__(RESCORE_MMA_WARPS * 32)
    rescore_mma_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ norms,
                       const __nv_bfloat16* __restrict__ x, const int* __restrict__ cand,
                       float* __restrict__ out, long long n, int d, int dp, int kc, int t) {
  constexpr int ROWS = RESCORE_MMA_ROWS;
  constexpr int WTN = ROWS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = SMEM_PAD_BYTES / 2;
  constexpr int KSTEP = MMA_KBYTES / 2;  // bf16 elements per k-step
  const int qst = dp + PAD;
  const int xst = kc + PAD;
  __nv_bfloat16* qrow = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* zrow = qrow + qst;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* xs = zrow + qst + (size_t)warp * 2 * ROWS * xst;

  const long long slot = blockIdx.x;
  const int qi = (int)(slot / t);
  load_tile<__nv_bfloat16, VEC>(qrow, qst, q + (size_t)qi * d, d, 1, 1, 0, dp, d, threadIdx.x,
                                blockDim.x);
  cp_async_commit();
  for (int i = threadIdx.x; i < qst; i += blockDim.x) zrow[i] = __float2bfloat16(0.f);
  cp_async_wait<0>();
  __syncthreads();  // the last block-wide barrier

  const int g = __ldg(cand + slot);
  const int c0 = warp * ROWS;  // this warp's first column (row of the group)
  const long long r0 = (long long)g * GROUP + c0;
  float* o = out + slot * GROUP + c0;
  if (g < 0 || r0 >= n) {  // none of this warp's rows exists
    for (int r = lane; r < ROWS; r += 32) o[r] = INFINITY;
    return;
  }
  const int valid = (int)min((long long)ROWS, n - r0);
  const int nchunks = (dp + kc - 1) / kc;
  auto fetch = [&](int c) {
    load_tile<__nv_bfloat16, VEC>(xs + (size_t)(c & 1) * ROWS * xst, xst, x + r0 * d, d, ROWS,
                                  valid, c * kc, min(kc, dp - c * kc), d, lane, 32);
    cp_async_commit();
  };
  fetch(0);

  const int arow = qi % 16;
  uint32_t a[1] = {smem_u32(a_lane_row(lane) == arow ? qrow : zrow) + a_lane_byte(lane)};
  const uint32_t b_pair = 16 * xst * 2;
  const uint32_t b_stage = ROWS * xst * 2;
  const uint32_t b0 = smem_u32(xs + (size_t)b_lane_row(lane) * xst) + b_lane_byte(lane);
  float acc[1][WTN][4];
  zero_acc(acc);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      fetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    uint32_t ac[1] = {a[0] + (uint32_t)c * kc * 2};
    mma_steps<MmaBf16, 1, WTN>(ac, b0 + (uint32_t)(c & 1) * b_stage, b_pair,
                               min(kc, dp - c * kc) / KSTEP, acc);
    __syncwarp();  // the warp is done with stage c & 1 before it is refilled
  }
  if ((lane >> 2) == arow % 8) {  // the lanes holding A row arow: registers 2h, 2h + 1
    const int h = arow / 8;
#pragma unroll
    for (int ni = 0; ni < WTN; ++ni) {
      const int col = ni * 8 + 2 * (lane & 3);
      float2 sc;
      sc.x = col < valid ? score_of(__ldg(norms + r0 + col), acc[0][ni][2 * h]) : INFINITY;
      sc.y = col + 1 < valid ? score_of(__ldg(norms + r0 + col + 1), acc[0][ni][2 * h + 1])
                             : INFINITY;
      *reinterpret_cast<float2*>(o + col) = sc;
    }
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
