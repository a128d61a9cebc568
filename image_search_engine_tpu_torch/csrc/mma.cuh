// Tensor-core building blocks of the port's kernels on Hopper (sm_90a):
// mma.sync products, their ldmatrix operand loads from padded shared memory,
// cp.async tile copies, and the 3xTF32 split. Used by the flat search's
// group-min sweep (groupmin_mma.cuh: bf16 and int8 stores), its bf16 rescore
// (topk_twophase.cu), and the warpgroup-MMA kernels (groupmin_tf32.cu: the
// f32 store's sweep and rescore; kmeans_assign.cu), which take their A
// operand in mma.sync m16n8k8's tf32 fragment.
//
//   bf16  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//   int8  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   tf32  (m16n8k8, the A fragment only)
//
// All three are 32 bytes deep, and their fragments sit at the same byte
// offsets: an A register holds 4 bytes of one row (two bf16 values, four
// int8 codes or one tf32), a0..a3 being rows g / g + 8 at byte 4 * tig and
// 16 + 4 * tig of the k-step (g = lane / 4, tig = lane % 4); B's two
// registers hold bytes 4 * tig and 16 + 4 * tig of column g; the four
// accumulators (f32, or s32 for int8) are rows g / g + 8, columns 2 * tig and
// 2 * tig + 1. So one set of ldmatrix addresses, given in bytes, feeds every
// type: A as rows of the left operand (queries, points), B as rows of the
// right one (store rows, centroids), both contiguous along k, which is B's
// "col" layout. Every shared-memory row is padded by SMEM_PAD_BYTES, so the
// eight 16-byte rows of one ldmatrix matrix fall on eight different bank
// groups.
//
// An output element (A row i of a 16-row tile, B row j of an 8-row tile)
// lives in lane 4 * (i % 8) + (j % 8) / 2, register 2 * (i / 8) + j % 2 of
// that tile's accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MMA_KBYTES = 32;      // bytes of k per mma step, every type
constexpr int SMEM_PAD_BYTES = 16;  // appended to every shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This lane's row, and byte offset along k, inside a 16-row A tile for
// ldmatrix.x4 (matrices: rows 0-7 / 8-15 at bytes 0-15, then the same at
// bytes 16-31: the mma's a0..a3 order).
__device__ __forceinline__ int a_lane_row(int lane) { return lane & 15; }
__device__ __forceinline__ uint32_t a_lane_byte(int lane) { return (lane >> 4) << 4; }
// This lane's row and byte offset inside a 16-row pair of B tiles (rows =
// right-operand rows): matrices (rows 0-7, bytes 0-15), (rows 0-7, bytes
// 16-31), (rows 8-15, bytes 0-15), (rows 8-15, bytes 16-31), i.e. b0 b1 of
// the first n8 tile, then of the second.
__device__ __forceinline__ int b_lane_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ uint32_t b_lane_byte(int lane) { return ((lane >> 3) & 1) << 4; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one 16 x 8 x 16 bf16 tile, f32 accumulate
struct MmaBf16 {
  using Acc = float;
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                             float (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// c += a . b for one 16 x 8 x 32 int8 tile, exact s32 accumulate
struct MmaS8 {
  using Acc = int;
  static __device__ __forceinline__ void mma(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                             int (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <typename T>
struct MmaOf;
template <>
struct MmaOf<__nv_bfloat16> : MmaBf16 {};
template <>
struct MmaOf<int8_t> : MmaS8 {};

// An f32 bit pattern rounded to tf32 (10 explicit mantissa bits), to
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds a finite
// value: half a tf32 ulp added to the magnitude, the 13 low bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of an f32 value v (bits): hi = tf32(v), lo = tf32(v - hi).
// v - hi is exact in f32, so hi + lo is v within 2^-22 |v|.
__device__ __forceinline__ void tf32_split(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(bits);
  lo = tf32_rna(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

// The scoring routine of the bf16 and int8 kernels. acc[mi][ni] += A_mi .
// B_ni^T over `steps` k-steps of 32 bytes in ascending order, for a warp
// tile of WTM 16-row A tiles and WTN 8-row B tiles. a[mi]: this lane's
// shared-memory address in A tile mi (a_lane_row, a_lane_byte) at the first
// k; b: its address in the first pair of B tiles (b_lane_row, b_lane_byte)
// at the first k, pair p at b + p * b_pair bytes.
template <class Op, int WTM, int WTN>
__device__ __forceinline__ void mma_steps(const uint32_t (&a)[WTM], uint32_t b, uint32_t b_pair,
                                          int steps, typename Op::Acc (&acc)[WTM][WTN][4]) {
  static_assert(WTN % 2 == 0, "B tiles are loaded in pairs");
  for (int s = 0; s < steps; ++s) {
    const uint32_t koff = (uint32_t)s * MMA_KBYTES;
    uint32_t af[WTM][4];
#pragma unroll
    for (int mi = 0; mi < WTM; ++mi) ldmatrix_x4(a[mi] + koff, af[mi]);
#pragma unroll
    for (int p = 0; p < WTN / 2; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(b + p * b_pair + koff, bf);
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi) {
        Op::mma(af[mi], bf[0], bf[1], acc[mi][2 * p]);
        Op::mma(af[mi], bf[2], bf[3], acc[mi][2 * p + 1]);
      }
    }
  }
}

template <typename Acc, int WTM, int WTN>
__device__ __forceinline__ void zero_acc(Acc (&acc)[WTM][WTN][4]) {
#pragma unroll
  for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
    for (int ni = 0; ni < WTN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
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

__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }
__device__ __forceinline__ void set_zero(int8_t& v) { v = 0; }

// Rows [0, rows) x columns [c0, c0 + w) of a row-major matrix of T (row
// stride ld elements, row 0 at src) into shared memory (row stride sst
// elements, tile column 0 at dst), by threads tid of nthr. Rows at or past
// `valid` and columns at or past d are written as zeros. VEC elements per
// copy: 16 bytes of them (a 16-byte cp.async: d a multiple of VEC, 16-byte
// aligned rows), 4 bytes (a 4-byte cp.async: 4-byte aligned rows; every f32
// row) or, for bf16 and int8, one element (a plain load and store). w is a
// multiple of VEC.
template <typename T, int VEC>
__device__ __forceinline__ void load_tile(T* dst, int sst, const T* __restrict__ src, long long ld,
                                          int rows, int valid, int c0, int w, int d, int tid,
                                          int nthr) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  static_assert(BYTES == 16 || BYTES == 4 || VEC == 1, "copies of 16 or 4 bytes, or elements");
  const int per_row = w / VEC;
  for (int i = tid; i < rows * per_row; i += nthr) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * VEC;
    T* s = dst + (size_t)r * sst + c;
    const int col = c0 + c;
    const bool ok = r < valid && col < d;
    const T* g = ok ? src + (size_t)r * ld + col : src;
    if constexpr (BYTES == 16) {
      cp_async16(smem_u32(s), g, ok);
    } else if constexpr (BYTES == 4) {
      cp_async4(smem_u32(s), g, ok);
    } else if (ok) {
      *s = g[0];
    } else {
      set_zero(*s);
    }
  }
}

}  // namespace
