// Two-phase exact top-k for Hopper (sm_90a): the kernels of the flat search,
// with a plain C interface for ctypes (ops/_kernels.py builds this file with
// nvcc and binds it; ops/topk.py holds the wrappers and the plain PyTorch
// version of each kernel).
//
//   groupmin_kernel      phase 1, f32 store: for each 128-row group of the
//                        store and each query, min over the group of
//                        norms[r] - 2 q.x[r] on CUDA cores.
//   groupmin_mma_kernel  phase 1, bf16 store: the same mins from a tiled
//                        tensor-core sweep. Both replace
//                        image_search_engine_tpu/ops/topk_pallas.py
//                        _groupmin_kernel.
//   select_kernel        per query, the t smallest group mins in ascending
//                        (value, group id) order. Replaces _select_topt_kernel.
//   rescore_kernel       phase 2, f32 store: for each (query, candidate
//                        group) the 128 scores norms[r] - 2 q.x[r], read in
//                        place from the store (no gather buffer).
//   rescore_mma_kernel   phase 2, bf16 store: the same on tensor cores. Both
//                        replace _fused_rescore_kernel.
//
// Phase 1 and phase 2 score a row with one routine per store dtype: f32
// with row_dot (scoring.cuh: the same lane striding, the same explicit fmaf
// chain and the same butterfly reduction), bf16 with mma_bf16_steps
// (mma_bf16.cuh: the same lane, register and mma sequence for every score).
// A phase-1 group min is therefore bit for bit the min of the phase-2 scores
// of that group, so the certificate "k-th final score <= t-th selected group
// min" holds whenever t >= k.
//
// f32 stores are scored in IEEE f32 (fmaf, no TF32). bf16 stores multiply
// bf16 by bf16 (exact in f32) and accumulate in f32 on the tensor cores.
// Rows at or past n score +inf, so the store is never padded or copied per
// call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"
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

// Phase 1 for a bf16 store on tensor cores. Block b takes query tile
// b % nqt (BQ queries) and the slice of `gps` 128-row groups b / nqt, so
// the nqt blocks that read one slice run together and find it in L2. Each
// group's rows come in as k-chunks of kc columns (the whole padded row when
// it fits), cp.async double-buffered: chunk i + 1 loads while chunk i is
// multiplied. RESIDENT: the query tile stays in shared memory for the whole
// block (a batch of fewer than BQ queries stages only its own rows and one
// zero row, which the A rows past them read). Otherwise, where a resident
// tile of wide rows would leave an SM room for one block only, each stage
// holds the query tile's k-chunk beside the store's: the store is still
// read once per BQ queries, and two blocks share an SM. 8
// warps split the BQ x 128 output tile, WM along the queries and WN along
// the group's rows, each warp summing the whole of d for its own tile
// (mma_bf16_steps). The epilogue works on the accumulator fragment: rows
// past n score +inf, each thread takes the min over its columns, then over
// the four lanes of its quad with shuffles, then through shared memory over
// the WN warps that share the group; mins are written for queries < nq
// only. Shared memory (bytes: groupmin_mma_smem): the resident query tile
// min(BQ, nq + 1) x (dp + 8), two stages of 128 (+ BQ streamed) rows x (kc
// + 8), and WN x BQ floats for the cross-warp min.
template <int BQ>
struct MmaTile {
  static constexpr int WM = BQ >= 32 ? 2 : 1;  // warps along the queries
  static constexpr int WN = WARPS / WM;        // warps along the group's rows
  static constexpr int WTM = BQ / (16 * WM);   // 16-row A tiles per warp
  static constexpr int WTN = GROUP / (8 * WN); // 8-row B tiles per warp
};

__host__ __device__ inline size_t groupmin_mma_smem(int bq, int nq, int dp, int kc,
                                                    bool resident) {
  const int wn = WARPS / (bq >= 32 ? 2 : 1);
  // query rows staged (the last zero when nq < bq), or streamed per stage
  const int qsrows = resident ? min(bq, nq + 1) : 0;
  const int srows = resident ? GROUP : GROUP + bq;
  return (size_t)qsrows * (dp + SMEM_PAD) * 2 + (size_t)2 * srows * (kc + SMEM_PAD) * 2 +
         (size_t)wn * bq * 4;
}

template <int BQ, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
    groupmin_mma_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ norms,
                        const __nv_bfloat16* __restrict__ x, float* __restrict__ out, int nq,
                        long long n, int d, int dp, int kc, int ngroups, int nqt, int gps) {
  using Tile = MmaTile<BQ>;
  constexpr int WN = Tile::WN, WTM = Tile::WTM, WTN = Tile::WTN;
  constexpr int AROWS = RESIDENT ? 0 : BQ;  // streamed query rows at the head of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int qst = dp + SMEM_PAD;
  const int xst = kc + SMEM_PAD;
  const int qsrows = RESIDENT ? min(BQ, nq + 1) : 0;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = qs + (size_t)qsrows * qst;
  const int srows = AROWS + GROUP;  // rows per stage
  float* red = reinterpret_cast<float*>(xs + (size_t)2 * srows * xst);

  const int qt = blockIdx.x % nqt;
  const int q0 = qt * BQ;
  const int qrows = min(BQ, nq - q0);  // this tile's queries
  const int g0 = (int)(blockIdx.x / nqt) * gps;
  const int g1 = min(g0 + gps, ngroups);
  const int nchunks = (dp + kc - 1) / kc;
  const int ntiles = (g1 - g0) * nchunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;

  auto fetch = [&](int i) {  // chunk i % nchunks of the slice's group i / nchunks
    const int c = i % nchunks;
    const int w = min(kc, dp - c * kc);
    const long long r0 = (long long)(g0 + i / nchunks) * GROUP;
    const int valid = (int)min((long long)GROUP, n - r0);
    __nv_bfloat16* stage = xs + (size_t)(i & 1) * srows * xst;
    if constexpr (!RESIDENT)
      load_tile<VEC>(stage, xst, q + (size_t)q0 * d, d, BQ, qrows, c * kc, w, d, threadIdx.x,
                     THREADS);
    load_tile<VEC>(stage + (size_t)AROWS * xst, xst, x + r0 * d, d, GROUP, valid, c * kc, w, d,
                   threadIdx.x, THREADS);
    cp_async_commit();
  };
  // a resident query tile goes out in the first commit group, with the
  // first chunk
  if constexpr (RESIDENT)
    load_tile<VEC>(qs, qst, q + (size_t)q0 * d, d, qsrows, qrows, 0, dp, d, threadIdx.x, THREADS);
  fetch(0);

  uint32_t a[WTM];
#pragma unroll
  for (int mi = 0; mi < WTM; ++mi) {
    const int row = (wm * WTM + mi) * 16 + a_lane_row(lane);
    a[mi] = RESIDENT
                ? smem_u32(qs + (size_t)(row < qrows ? row : qsrows - 1) * qst + a_lane_col(lane))
                : smem_u32(xs + (size_t)row * xst + a_lane_col(lane));
  }
  const uint32_t b_pair = 16 * xst * 2;
  const uint32_t stage_bytes = srows * xst * 2;
  const uint32_t b0 = smem_u32(xs + (size_t)(AROWS + wn * WTN * 8 + b_lane_row(lane)) * xst +
                               b_lane_col(lane));

  float acc[WTM][WTN][4];
  zero_acc(acc);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = i % nchunks;
    const uint32_t stage = (uint32_t)(i & 1) * stage_bytes;
    uint32_t ac[WTM];
#pragma unroll
    for (int mi = 0; mi < WTM; ++mi) ac[mi] = a[mi] + (RESIDENT ? (uint32_t)c * kc * 2 : stage);
    mma_bf16_steps<WTM, WTN>(ac, b0 + stage, b_pair, min(kc, dp - c * kc) / MMA_K, acc);

    if (c == nchunks - 1) {  // the group's last chunk: its mins
      const int g = g0 + i / nchunks;
      const long long r0 = (long long)g * GROUP;
      float best[WTM][2];
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi) best[mi][0] = best[mi][1] = INFINITY;
#pragma unroll
      for (int ni = 0; ni < WTN; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long row = r0 + (wn * WTN + ni) * 8 + 2 * (lane & 3) + e;
          const bool ok = row < n;
          const float nr = ok ? __ldg(norms + row) : 0.f;
#pragma unroll
          for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              best[mi][h] =
                  fminf(best[mi][h], ok ? score_of(nr, acc[mi][ni][2 * h + e]) : INFINITY);
        }
      }
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          best[mi][h] = fminf(best[mi][h], __shfl_xor_sync(0xffffffffu, best[mi][h], 1));
          best[mi][h] = fminf(best[mi][h], __shfl_xor_sync(0xffffffffu, best[mi][h], 2));
          if ((lane & 3) == 0)
            red[wn * BQ + (wm * WTM + mi) * 16 + h * 8 + (lane >> 2)] = best[mi][h];
        }
      __syncthreads();
      for (int r = threadIdx.x; r < BQ && q0 + r < nq; r += THREADS) {
        float m = red[r];
#pragma unroll
        for (int w = 1; w < WN; ++w) m = fminf(m, red[w * BQ + r]);
        out[(size_t)(q0 + r) * ngroups + g] = m;
      }
      zero_acc(acc);
    }
    __syncthreads();  // every warp is done with stage i & 1 (and red) before it is refilled
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
  return (size_t)2 * (dp + SMEM_PAD) * 2 +
         (size_t)RESCORE_MMA_WARPS * 2 * RESCORE_MMA_ROWS * (kc + SMEM_PAD) * 2;
}

template <int VEC>
__global__ void __launch_bounds__(RESCORE_MMA_WARPS * 32)
    rescore_mma_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ norms,
                       const __nv_bfloat16* __restrict__ x, const int* __restrict__ cand,
                       float* __restrict__ out, long long n, int d, int dp, int kc, int t) {
  constexpr int ROWS = RESCORE_MMA_ROWS;
  constexpr int WTN = ROWS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qst = dp + SMEM_PAD;
  const int xst = kc + SMEM_PAD;
  __nv_bfloat16* qrow = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* zrow = qrow + qst;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* xs = zrow + qst + (size_t)warp * 2 * ROWS * xst;

  const long long slot = blockIdx.x;
  const int qi = (int)(slot / t);
  load_tile<VEC>(qrow, qst, q + (size_t)qi * d, d, 1, 1, 0, dp, d, threadIdx.x, blockDim.x);
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
    load_tile<VEC>(xs + (size_t)(c & 1) * ROWS * xst, xst, x + r0 * d, d, ROWS, valid, c * kc,
                   min(kc, dp - c * kc), d, lane, 32);
    cp_async_commit();
  };
  fetch(0);

  const int arow = qi % 16;
  uint32_t a[1] = {smem_u32((a_lane_row(lane) == arow ? qrow : zrow) + a_lane_col(lane))};
  const uint32_t b_pair = 16 * xst * 2;
  const uint32_t b_stage = ROWS * xst * 2;
  const uint32_t b0 = smem_u32(xs + (size_t)b_lane_row(lane) * xst + b_lane_col(lane));
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
    mma_bf16_steps<1, WTN>(ac, b0 + (uint32_t)(c & 1) * b_stage, b_pair,
                           min(kc, dp - c * kc) / MMA_K, acc);
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

template <int BQ, int VEC, bool RESIDENT>
cudaError_t launch_groupmin_mma(const void* q, const void* norms, const void* x, void* out, int nq,
                                long long n, int d, int dp, int kc, int gps, size_t smem,
                                cudaStream_t stream) {
  const int ngroups = (int)((n + GROUP - 1) / GROUP);
  const int nqt = (nq + BQ - 1) / BQ;
  const long long grid = (long long)((ngroups + gps - 1) / gps) * nqt;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = groupmin_mma_kernel<BQ, VEC, RESIDENT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(norms),
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), nq, n, d, dp, kc, ngroups,
      nqt, gps);
  return cudaGetLastError();
}

template <int VEC, bool RESIDENT>
cudaError_t groupmin_mma_bq(const void* q, const void* norms, const void* x, void* out, int nq,
                            long long n, int d, int bq, int dp, int kc, int gps, size_t smem,
                            cudaStream_t s) {
  switch (bq) {
    case 16:
      return launch_groupmin_mma<16, VEC, RESIDENT>(q, norms, x, out, nq, n, d, dp, kc, gps, smem,
                                                    s);
    case 32:
      return launch_groupmin_mma<32, VEC, RESIDENT>(q, norms, x, out, nq, n, d, dp, kc, gps, smem,
                                                    s);
    case 64:
      return launch_groupmin_mma<64, VEC, RESIDENT>(q, norms, x, out, nq, n, d, dp, kc, gps, smem,
                                                    s);
    case 128:
      return launch_groupmin_mma<128, VEC, RESIDENT>(q, norms, x, out, nq, n, d, dp, kc, gps,
                                                     smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int VEC>
cudaError_t groupmin_mma_vec(const void* q, const void* norms, const void* x, void* out, int nq,
                             long long n, int d, int bq, int dp, int kc, int gps, int resident,
                             size_t smem, cudaStream_t s) {
  return resident ? groupmin_mma_bq<VEC, true>(q, norms, x, out, nq, n, d, bq, dp, kc, gps, smem, s)
                  : groupmin_mma_bq<VEC, false>(q, norms, x, out, nq, n, d, bq, dp, kc, gps, smem,
                                                s);
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

// A tile plan the kernels can take: dp the padded d, kc a multiple of 16,
// and the shared memory the plan reserved at least what the layout needs.
bool mma_plan_ok(int d, int dp, int kc, size_t smem, size_t need) {
  return d > 0 && dp % MMA_K == 0 && dp >= d && dp - d < MMA_K && kc > 0 && kc % MMA_K == 0 &&
         smem >= need;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gps < 1 ||
      !mma_plan_ok(d, dp, kc, (size_t)smem, groupmin_mma_smem(bq, nq, dp, kc, resident != 0)))
    return cudaErrorInvalidValue;
  if (vec == 8)
    return groupmin_mma_vec<8>(q, norms, x, out, nq, n, d, bq, dp, kc, gps, resident, smem, s);
  if (vec == 2)
    return groupmin_mma_vec<2>(q, norms, x, out, nq, n, d, bq, dp, kc, gps, resident, smem, s);
  if (vec == 1)
    return groupmin_mma_vec<1>(q, norms, x, out, nq, n, d, bq, dp, kc, gps, resident, smem, s);
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
  if (!mma_plan_ok(d, dp, kc, (size_t)smem, rescore_mma_smem(dp, kc))) return cudaErrorInvalidValue;
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
