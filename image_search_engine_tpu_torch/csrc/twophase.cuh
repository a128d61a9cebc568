// The flat search's per-block routines of topk_twophase.cu, as device
// functions that take their work item (b, or the candidate slot) in place
// of blockIdx.x: the f32 phase 1 and phase 2 on CUDA cores and the bf16
// phase 2 on tensor cores. topk_twophase.cu's kernels call them with
// blockIdx.x; the merged search (topk_merged.cu) calls them from one
// persistent launch, so both searches score every row with the same code.
//
// A phase-2 routine takes its candidate group through `group_of(slot)`,
// called where the kernel reads it: the kernels read cand through the
// read-only path (__ldg), which is right for groups selected by an earlier
// launch; the merged search passes the group it read through L2 after the
// select that wrote it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "mma.cuh"
#include "scoring.cuh"

namespace {

constexpr int RESCORE_SPLIT = 4;  // phase-2 blocks per candidate group

// Phase 1. Block b handles query tile b % nqt (QT queries) of group b / nqt,
// so the nqt blocks that read one group run back to back and share it in L2.
// Output is query-major: out[qi * ngroups + g]. Every thread of the block
// calls it (THREADS), with QT * d floats of dynamic shared memory.
template <typename T, int VEC, int QT>
__device__ __forceinline__ void groupmin_block(const T* q, const float* norms, const T* x,
                                               float* out, int nq, long long n, int d, int ngroups,
                                               int nqt, unsigned b) {
  extern __shared__ float qs[];  // QT * d
  __shared__ float red[WARPS][QT];
  const int qt = b % nqt;
  const int g = b / nqt;
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

// Phase 2. Block b scores rows [s*32, s*32+32) of candidate slot b / SPLIT
// (slot = query * t + j, s = b % SPLIT). out[slot * GROUP + r]. Every
// thread of the block calls it (THREADS), with d floats of dynamic shared
// memory.
template <typename T, int VEC, class GroupOf>
__device__ __forceinline__ void rescore_block(const T* q, const float* norms, const T* x,
                                              float* out, long long n, int d, int t, unsigned b,
                                              GroupOf group_of) {
  extern __shared__ float qs[];  // d
  constexpr int ROWS = GROUP / RESCORE_SPLIT;
  const int s = b % RESCORE_SPLIT;
  const long long slot = b / RESCORE_SPLIT;
  const int qi = (int)(slot / t);
  stage_queries(q, qs, qi, 1, qi + 1, d);
  __syncthreads();

  const int g = group_of(slot);
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

// The threads that run a routine and their barrier: the whole block.
struct BlockThreads {
  static __device__ __forceinline__ unsigned tid() { return threadIdx.x; }
  static __device__ __forceinline__ unsigned count() { return blockDim.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

// Phase 2 for a bf16 store on tensor cores. The (query, candidate group)
// pair of slot slot_of() on RESCORE_MMA_WARPS warps (the Threads policy's:
// Threads::tid() = 0 .. Threads::count() - 1, Threads::sync() their
// barrier; smem their rescore_mma_smem bytes); its warps take 32 of the
// group's rows each. Threads and slot_of are read where the kernel reads
// threadIdx.x, blockDim.x and blockIdx.x, so it compiles as it did before
// the body moved here. The query sits in A row (query % 16), every other A
// row is zero (those lanes read a zero row), and the group's row r sits in
// column r % 32 of warp r / 32: the same lane and register of an 8-row B
// tile as phase 1 gives it, and every score runs the same mma sequence over
// the whole of d. The query row and the zero row are staged once per pair;
// each warp streams its 32 rows in k-chunks of kc columns, cp.async
// double-buffered in its own two stages (four warps keep four chunks of a
// pair in flight, where a single warp would stream all 128 rows in one
// chain of dependent chunks). out[slot * GROUP + r], +inf for rows at or
// past n. kc only sets the chunking: the k-steps run in the same order
// whatever it is.
constexpr int RESCORE_MMA_WARPS = 4;
constexpr int RESCORE_MMA_ROWS = GROUP / RESCORE_MMA_WARPS;  // rows per warp

__host__ __device__ inline size_t rescore_mma_smem(int dp, int kc) {
  return (size_t)2 * (dp * 2 + SMEM_PAD_BYTES) +
         (size_t)RESCORE_MMA_WARPS * 2 * RESCORE_MMA_ROWS * (kc * 2 + SMEM_PAD_BYTES);
}

template <int VEC, class Threads, class SlotOf, class GroupOf>
__device__ __forceinline__ void rescore_mma_block(const __nv_bfloat16* q, const float* norms,
                                                  const __nv_bfloat16* x, float* out, long long n,
                                                  int d, int dp, int kc, int t,
                                                  unsigned char* smem, SlotOf slot_of,
                                                  GroupOf group_of) {
  constexpr int ROWS = RESCORE_MMA_ROWS;
  constexpr int WTN = ROWS / 8;
  constexpr int PAD = SMEM_PAD_BYTES / 2;
  constexpr int KSTEP = MMA_KBYTES / 2;  // bf16 elements per k-step
  const int qst = dp + PAD;
  const int xst = kc + PAD;
  __nv_bfloat16* qrow = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* zrow = qrow + qst;
  const int warp = Threads::tid() / 32;
  const int lane = Threads::tid() % 32;
  __nv_bfloat16* xs = zrow + qst + (size_t)warp * 2 * ROWS * xst;

  const long long slot = slot_of();
  const int qi = (int)(slot / t);
  load_tile<__nv_bfloat16, VEC>(qrow, qst, q + (size_t)qi * d, d, 1, 1, 0, dp, d,
                                Threads::tid(), Threads::count());
  cp_async_commit();
  for (int i = Threads::tid(); i < qst; i += Threads::count()) zrow[i] = __float2bfloat16(0.f);
  cp_async_wait<0>();
  Threads::sync();  // the last barrier of the pair's threads

  const int g = group_of(slot);
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

}  // namespace
