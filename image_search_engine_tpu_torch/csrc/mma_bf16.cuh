// The bf16 scoring routine of the flat search on Hopper's tensor cores,
// shared by its bf16 phase 1 (groupmin_mma_kernel) and phase 2
// (rescore_mma_kernel) in topk_twophase.cu: nothing else scores a bf16 row
// there.
//
// The product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with
// queries as A (16 rows) and store rows as B: a store row, contiguous along
// d, is already B's "col" layout. Both operands come from shared memory with
// ldmatrix; every shared-memory row is padded by SMEM_PAD elements, so the
// eight 16-byte rows of one ldmatrix matrix fall on eight different bank
// groups. d is zero-padded to a multiple of 16 in shared memory. The k-loop
// runs in ascending 16-wide steps from an accumulator of 0, and a warp
// always sums the whole of d itself: the sum is never split across warps.
// The score to minimize is score_of (scoring.cuh), fmaf(-2, dot, norm).
//
// An output element (query row i of a 16-row A tile, store row j of an
// 8-row B tile) lives in lane 4 * (i % 8) + (j % 8) / 2, register
// 2 * (i / 8) + j % 2 of that tile's accumulator, in both kernels: phase 2
// puts its query in A row (query % 16) and a group's rows in the columns
// phase 1 gives them, so every score is computed by the same lane, register
// and instruction sequence in both phases, and a group's phase-1 min is bit
// for bit the min of its phase-2 scores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MMA_K = 16;    // bf16 elements per k-step
constexpr int SMEM_PAD = 8;  // bf16 elements appended to every shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This lane's row address inside a 16 x 16 A tile for ldmatrix.x4 (matrices:
// rows 0-7 / 8-15 at columns 0-7, then the same at columns 8-15: the mma's
// a0..a3 order).
__device__ __forceinline__ int a_lane_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_lane_col(int lane) { return (lane >> 4) << 3; }
// This lane's row address inside a 16-row x 16-column pair of B tiles
// (rows = store rows): matrices (rows 0-7, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 0-7), (rows 8-15, k 8-15), i.e. b0 b1 of the first n8
// tile, then of the second.
__device__ __forceinline__ int b_lane_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_lane_col(int lane) { return ((lane >> 3) & 1) << 3; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one 16 x 8 x 16 tile, f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                               float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The scoring routine. acc[mi][ni] += A_mi . B_ni^T over `steps` 16-wide
// k-steps in ascending order, for a warp tile of WTM 16-row A tiles and WTN
// 8-row B tiles. a[mi]: this lane's shared-memory address in A tile mi
// (a_lane_row, a_lane_col) at the first k; b: its address in the first
// pair of B tiles (b_lane_row, b_lane_col) at the first k, pair p at
// b + p * b_pair bytes.
template <int WTM, int WTN>
__device__ __forceinline__ void mma_bf16_steps(const uint32_t (&a)[WTM], uint32_t b,
                                               uint32_t b_pair, int steps,
                                               float (&acc)[WTM][WTN][4]) {
  static_assert(WTN % 2 == 0, "B tiles are loaded in pairs");
  for (int s = 0; s < steps; ++s) {
    const uint32_t koff = (uint32_t)s * MMA_K * 2;
    uint32_t af[WTM][4];
#pragma unroll
    for (int mi = 0; mi < WTM; ++mi) ldmatrix_x4(a[mi] + koff, af[mi]);
#pragma unroll
    for (int p = 0; p < WTN / 2; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(b + p * b_pair + koff, bf);
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi) {
        mma_bf16_16816(af[mi], bf[0], bf[1], acc[mi][2 * p]);
        mma_bf16_16816(af[mi], bf[2], bf[3], acc[mi][2 * p + 1]);
      }
    }
  }
}

template <int WTM, int WTN>
__device__ __forceinline__ void zero_acc(float (&acc)[WTM][WTN][4]) {
#pragma unroll
  for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
    for (int ni = 0; ni < WTN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// ---- global -> shared copies ----

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) x columns [c0, c0 + w) of a row-major bf16 matrix (row
// stride ld elements, row 0 at src) into shared memory (row stride sst, tile
// column 0 at dst), by threads tid of nthr. Rows at or past `valid` and
// columns at or past d are written as zeros. VEC elements per copy: 8 (a
// 16-byte cp.async: d % 8 == 0, 16-byte aligned rows), 2 (4-byte cp.async:
// d even, 4-byte aligned) or 1 (a plain load and store). w % 16 == 0.
template <int VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int sst,
                                          const __nv_bfloat16* __restrict__ src, long long ld,
                                          int rows, int valid, int c0, int w, int d, int tid,
                                          int nthr) {
  const int per_row = w / VEC;
  for (int i = tid; i < rows * per_row; i += nthr) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * VEC;
    __nv_bfloat16* s = dst + (size_t)r * sst + c;
    const int col = c0 + c;
    const bool ok = r < valid && col < d;
    const __nv_bfloat16* g = ok ? src + (size_t)r * ld + col : src;
    if constexpr (VEC == 8) {
      cp_async16(smem_u32(s), g, ok);
    } else if constexpr (VEC == 2) {
      cp_async4(smem_u32(s), g, ok);
    } else {
      *s = ok ? g[0] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace
