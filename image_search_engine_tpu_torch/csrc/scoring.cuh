// Per-row scoring shared by the flat search's kernels (topk_twophase.cu,
// topk_twophase_q8.cu) and the IVF probed scan (ivf_probed_scan.cu): one warp
// computes a row's dot product with the staged query (the same lane striding,
// the same explicit fmaf chain, the same butterfly reduction everywhere), and
// the score to minimize is norm - 2 * dot, rounded once.
//
// f32 rows are scored in IEEE f32 (fmaf, no TF32). bf16 rows are read as bf16,
// widened to f32 (exact) and accumulated in f32. int8 rows are multiplied with
// int8 queries into exact int32 sums, then scaled in an f32 epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive row elements widened to f32; VEC > 1 is one 16-byte load.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// acc[qi] = q_qi . row for QT queries staged as f32 in shared memory
// (qs[qi * d + j]); every lane of the warp ends with the same sums.
template <typename T, int VEC, int QT>
__device__ __forceinline__ void row_dot(const T* __restrict__ row, const float* qs, int d,
                                        int lane, float (&acc)[QT]) {
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) acc[qi] = 0.f;
  const int nvec = d / VEC;
#pragma unroll 4
  for (int c = lane; c < nvec; c += 32) {
    float xv[VEC];
    Loader<T, VEC>::load(row + (size_t)c * VEC, xv);
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const float* qp = qs + (size_t)qi * d + (size_t)c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[qi] = fmaf(qp[e], xv[e], acc[qi]);
    }
  }
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], off);
  }
}

// score to minimize; 2*dot is exact, so this is norm - 2*dot rounded once
__device__ __forceinline__ float score_of(float norm, float dot) { return fmaf(-2.f, dot, norm); }

// rows queries from q0 on, widened to f32 into shared memory; rows past nq
// are zero
template <typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, float* qs, int q0, int rows,
                                              int nq, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int qi = i / d;
    const int j = i - qi * d;
    qs[i] = (q0 + qi < nq) ? to_f32(q[(size_t)(q0 + qi) * d + j]) : 0.f;
  }
}

// ---- int8 rows (topk_twophase_q8.cu) ----
//
// acc[qi] = q_qi . row for QT int8 queries staged in shared memory
// (qs[qi * d + j]), summed in int32: exact in any order, so every lane ends
// with the same exact sums and a row scores the same in every kernel. VEC =
// 16 reads 16 codes per 16-byte load (rows and query rows 16-byte aligned)
// and multiplies them four at a time with __dp4a; VEC = 1 reads one code at
// a time.
template <int VEC, int QT>
__device__ __forceinline__ void row_dot_q8(const int8_t* __restrict__ row, const int8_t* qs, int d,
                                           int lane, int (&acc)[QT]) {
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) acc[qi] = 0;
  if constexpr (VEC == 16) {
    const int nvec = d / 16;
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32) {
      const int4 xv = __ldg(reinterpret_cast<const int4*>(row) + c);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const int4 qv = reinterpret_cast<const int4*>(qs + (size_t)qi * d)[c];
        acc[qi] = __dp4a(xv.x, qv.x, acc[qi]);
        acc[qi] = __dp4a(xv.y, qv.y, acc[qi]);
        acc[qi] = __dp4a(xv.z, qv.z, acc[qi]);
        acc[qi] = __dp4a(xv.w, qv.w, acc[qi]);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const int xv = __ldg(row + c);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) acc[qi] += xv * (int)qs[(size_t)qi * d + c];
    }
  }
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], off);
  }
}

// The int8 score to minimize, norm - f32(dot) * (qs2 * scale) with qs2 = 2 *
// the query's scale: every step rounded once, in the plain version's order
// (the _rn intrinsics keep nvcc from contracting them into an FMA).
__device__ __forceinline__ float score_q8(float norm, int dot, float qs2, float scale) {
  return __fsub_rn(norm, __fmul_rn(__int2float_rn(dot), __fmul_rn(qs2, scale)));
}

// rows int8 queries from q0 on into shared memory, 16 bytes at a time when
// VEC = 16; rows past nq are zero
template <int VEC>
__device__ __forceinline__ void stage_queries_q8(const int8_t* __restrict__ q, int8_t* qs, int q0,
                                                 int rows, int nq, int d) {
  if constexpr (VEC == 16) {
    const int per_row = d / 16;
    const int4* src = reinterpret_cast<const int4*>(q);
    int4* dst = reinterpret_cast<int4*>(qs);
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int qi = i / per_row;
      dst[i] = (q0 + qi < nq) ? src[(size_t)q0 * per_row + i] : make_int4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int qi = i / d;
      qs[i] = (q0 + qi < nq) ? q[(size_t)q0 * d + i] : (int8_t)0;
    }
  }
}

}  // namespace
