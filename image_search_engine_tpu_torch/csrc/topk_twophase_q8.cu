// Two-phase exact top-k over an int8 store for Hopper (sm_90a), with a plain
// C interface for ctypes (ops/_kernels.py builds this file with nvcc and binds
// it; ops/topk.py holds the wrappers and the plain PyTorch version of each
// kernel). The select between the phases is select_topt.cu's.
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
//                       store, one warp per row. Replaces
//                       _fused_rescore_kernel_q8.
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
// scattered groups per query, a few dozen at Q = 1 (t * 128 * d bytes, a
// few microseconds at the memory rate), and stays on the CUDA cores: it is
// bound by how many bytes are in flight, so it gives each row its own warp
// (16 blocks of 8 warps per group), reads the query's chunks beside the
// row's from L2 with no staging barrier, and issues a row's 16-byte loads
// before their __dp4a chain. The CUDA-core kernels read 16 codes per
// 16-byte load and multiply them with __dp4a (row_dot_q8, scoring.cuh, and
// row_dot_q8_direct; a scalar loop takes rows that are not 16-byte
// multiples). Integer sums are exact in any order and the
// padding adds 0, so every kernel gives the same int32 for a row, and all
// run the same f32 epilogue (score_q8, rounded step by step in the plain
// version's order): each kernel equals its plain version bit for bit, and a
// phase-1 group min is the min of its phase-2 scores, which keeps the
// certificate valid whenever t >= k. Rows at or past n score +inf, so the
// store is never padded or copied per call.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "scoring.cuh"

namespace {

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

// Phase 2, one warp per row: block b scores rows [part * RESCORE_Q8_WARPS,
// part * RESCORE_Q8_WARPS + RESCORE_Q8_WARPS) of candidate slot order[b /
// RESCORE_Q8_BLOCKS] (slot = query * t + j, part = b % RESCORE_Q8_BLOCKS;
// without order the slot is b / RESCORE_Q8_BLOCKS), warp w the part's row
// w: 16 blocks of 8 warps a group, so that even the served query's few
// dozen groups put many rows in flight. No barrier: each lane reads the
// same 16-byte chunks of the query as of its row, from L2 into registers,
// and issues all of a step's loads before its dp4a chain. An order that
// groups the slots by group (group_order_kernel, for batches whose slots
// share groups: ops/topk.py rescore_q8_order) makes the queries that picked
// one group read it back to back, the second and later from L2. The int32
// sum is exact in any order and the epilogue is score_q8, so every score
// equals phase 1's for the row bit for bit, and a slot's scores do not
// depend on the order. out[slot * GROUP + r].
constexpr int RESCORE_Q8_WARPS = 8;                          // rows per block
constexpr int RESCORE_Q8_BLOCKS = GROUP / RESCORE_Q8_WARPS;  // blocks per candidate group
constexpr int RESCORE_Q8_UNROLL = 4;  // 16-byte chunks per lane in flight: a 2048-code row

// q . row over d codes, summed in int32 across the warp (every lane ends
// with the sum): VEC = 16 reads 16 codes of each per 16-byte load (rows and
// query 16-byte aligned, d a multiple of 16), VEC = 1 one code at a time.
template <int VEC>
__device__ __forceinline__ int row_dot_q8_direct(const int8_t* __restrict__ row,
                                                 const int8_t* __restrict__ qrow, int d,
                                                 int lane) {
  int acc = 0;
  if constexpr (VEC == 16) {
    const int4* xr = reinterpret_cast<const int4*>(row);
    const int4* qr = reinterpret_cast<const int4*>(qrow);
    const int nvec = d / 16;
    for (int c0 = lane; c0 < nvec; c0 += 32 * RESCORE_Q8_UNROLL) {
      int4 xv[RESCORE_Q8_UNROLL], qv[RESCORE_Q8_UNROLL];
#pragma unroll
      for (int u = 0; u < RESCORE_Q8_UNROLL; ++u) {
        const int c = c0 + 32 * u;
        xv[u] = c < nvec ? __ldg(xr + c) : make_int4(0, 0, 0, 0);
        qv[u] = c < nvec ? __ldg(qr + c) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < RESCORE_Q8_UNROLL; ++u) {
        acc = __dp4a(xv[u].x, qv[u].x, acc);
        acc = __dp4a(xv[u].y, qv[u].y, acc);
        acc = __dp4a(xv[u].z, qv[u].z, acc);
        acc = __dp4a(xv[u].w, qv[u].w, acc);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) acc += (int)__ldg(row + c) * (int)__ldg(qrow + c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int VEC>
__global__ void __launch_bounds__(RESCORE_Q8_WARPS * 32)
    rescore_q8_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
                      const float* __restrict__ norms, const float* __restrict__ scales,
                      const int8_t* __restrict__ x, const int* __restrict__ cand,
                      const int* __restrict__ order, float* __restrict__ out, long long n,
                      int d, int t) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long slot = order != nullptr ? (long long)__ldg(order + blockIdx.x / RESCORE_Q8_BLOCKS)
                                          : (long long)(blockIdx.x / RESCORE_Q8_BLOCKS);
  const int r = (int)(blockIdx.x % RESCORE_Q8_BLOCKS) * RESCORE_Q8_WARPS + warp;
  const int qi = (int)(slot / t);
  const int g = __ldg(cand + slot);
  const long long row = (long long)g * GROUP + r;
  float score = INFINITY;
  if (g >= 0 && row < n) {  // warp-uniform
    const float nr = __ldg(norms + row);
    const float sc = __ldg(scales + row);
    const float qs2 = __fmul_rn(2.f, __ldg(qscale + qi));
    const int acc = row_dot_q8_direct<VEC>(x + row * d, q + (size_t)qi * d, d, lane);
    score = score_q8(nr, acc, qs2, sc);
  }
  if (lane == 0) out[slot * GROUP + r] = score;
}

// The int8 rescore's slot order: the candidate slots grouped by group id,
// groups ascending (ids below 0 first, ids of ng or more last), by a
// counting sort in one block. bins (ng + 2 ints of device scratch, read and
// written past L1) count each group's slots; an exclusive scan turns the
// counts into offsets and lists the bins that have slots (live[0] their
// number, live[1 ..] their ids ascending); each slot then takes the next
// place of its group (atomically, so the order within a group varies, which
// the rescore's scores do not depend on), which leaves each bin's end in
// bins. Three barriers; a few microseconds for a batch's few thousand
// slots.
constexpr int ORDER_THREADS = 1024;

__device__ __forceinline__ int order_bin(int g, int ng) {
  return g < 0 ? 0 : (g < ng ? g + 1 : ng + 1);
}

__global__ void __launch_bounds__(ORDER_THREADS)
    group_order_kernel(const int* __restrict__ cand, int* __restrict__ order, int* bins,
                       int* __restrict__ live, int slots, int ng) {
  __shared__ int wsum[ORDER_THREADS / 32], wlive[ORDER_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nb = ng + 2;
  for (int b = tid; b < nb; b += ORDER_THREADS) __stcg(bins + b, 0);
  __syncthreads();
  for (int i = tid; i < slots; i += ORDER_THREADS)
    atomicAdd(bins + order_bin(__ldg(cand + i), ng), 1);
  __syncthreads();
  // exclusive scan: thread tid owns bins [b0, b1)
  const int per = (nb + ORDER_THREADS - 1) / ORDER_THREADS;
  const int b0 = min(nb, tid * per);
  const int b1 = min(nb, b0 + per);
  int sum = 0, nlive = 0;  // the thread's slots and bins that have any
  for (int b = b0; b < b1; ++b) {
    const int c = __ldcg(bins + b);
    sum += c;
    nlive += c > 0;
  }
  int x = sum, xl = nlive;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    const int yl = __shfl_up_sync(0xffffffffu, xl, off);
    if (lane >= off) {
      x += y;
      xl += yl;
    }
  }
  if (lane == 31) {
    wsum[warp] = x;
    wlive[warp] = xl;
  }
  __syncthreads();
  int run = x - sum, lrun = xl - nlive;
  for (int w = 0; w < warp; ++w) {
    run += wsum[w];
    lrun += wlive[w];
  }
  for (int b = b0; b < b1; ++b) {
    const int c = __ldcg(bins + b);
    __stcg(bins + b, run);
    run += c;
    if (c > 0) live[1 + lrun++] = b;
  }
  if (tid == ORDER_THREADS - 1) live[0] = lrun;  // the last range's running count: all of them
  __syncthreads();
  for (int i = tid; i < slots; i += ORDER_THREADS)
    order[atomicAdd(bins + order_bin(__ldg(cand + i), ng), 1)] = i;
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
                              const void* scales, const void* x, const void* cand,
                              const void* order, void* out, int nq, long long n, int d, int t,
                              cudaStream_t stream) {
  const long long grid = (long long)nq * t * RESCORE_Q8_BLOCKS;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  rescore_q8_kernel<VEC><<<(unsigned)grid, RESCORE_Q8_WARPS * 32, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qscale),
      static_cast<const float*>(norms), static_cast<const float*>(scales),
      static_cast<const int8_t*>(x), static_cast<const int*>(cand),
      static_cast<const int*>(order), static_cast<float*>(out), n, d, t);
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

// The nq * t candidate slots of cand grouped by group id into order (int32,
// a permutation); bins (ng + 2 int32) ends as each bin's end in order, live
// (ng + 3 int32) as the number of bins that have slots, then their ids.
int ise_group_order(const void* cand, void* order, void* bins, void* live, int slots, int ng,
                    void* stream) {
  if (slots < 1 || ng < 0 || ng > INT_MAX - 3) return cudaErrorInvalidValue;
  group_order_kernel<<<1, ORDER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<int*>(order), static_cast<int*>(bins),
      static_cast<int*>(live), slots, ng);
  return cudaGetLastError();
}

// Phase 2. order: null, or the nq * t candidate slots in the order to score
// them (a permutation). vec: 16 when store and query rows are 16-byte
// aligned, else 1.
int ise_rescore_q8(const void* q, const void* qscale, const void* norms, const void* scales,
                   const void* x, const void* cand, const void* order, void* out, int nq,
                   long long n, int d, int t, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    return launch_rescore_q8<16>(q, qscale, norms, scales, x, cand, order, out, nq, n, d, t, s);
  if (vec == 1)
    return launch_rescore_q8<1>(q, qscale, norms, scales, x, cand, order, out, nq, n, d, t, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
