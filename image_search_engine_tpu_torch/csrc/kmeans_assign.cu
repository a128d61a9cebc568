// K-means nearest-centroid assignment for Hopper (sm_90a), with a plain C
// interface for ctypes (ops/_kernels.py builds it; ops/kmeans.py holds the
// wrapper and the plain PyTorch version).
//
//   kmeans_assign_kernel  for each point x_i of each of B independent
//                         problems, codes[i] = argmin_j (|c_j|^2 - 2 x_i.c_j)
//                         (ties to the lowest j) and mins[i] = that minimum.
//                         Replaces image_search_engine_tpu/ops/
//                         kmeans_pallas.py _assign_kernel.
//
// Bound: 2*B*N*K*d flops, accumulated in IEEE f32 fmaf on the CUDA cores (no
// TF32), against N*d*4 bytes of points: at the coarse quantizer's shape
// (N = 1M, K = 1024, d = 2048) the flops bound it. A block owns 64 rows of
// one problem and walks all K centroids in 64-wide tiles; each step stages a
// 64 x 16 tile of points and one of centroids in shared memory (transposed,
// so a thread reads 4 rows and 4 centroids with two 16-byte loads) and each
// of the 256 threads accumulates a 4 x 4 register tile of dot products.
// After each centroid tile the thread folds its scores into a running
// (min, argmin) per row in registers; a 16-lane shuffle reduction finishes
// each row. The (N, K) distances never reach device memory, which is what
// the TPU kernel keeps out of HBM. The batch dimension (grid y) covers the
// product quantizer's m codebooks in one launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // centroids per tile
constexpr int BK = 16;   // depth per shared-memory step
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // centroids per thread
constexpr int PAD = 4;   // keeps 16-byte alignment, halves store conflicts
constexpr int ASSIGN_THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Stage rows [r0, r0 + 64) x columns [k0, k0 + 16) of a row-major matrix
// (row stride `stride` elements) transposed into tile[16][64 + PAD]; rows at
// or past `rows` and columns at or past d are zero. Each thread moves 4
// consecutive columns of one row.
template <int VEC>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, long long stride,
                                           long long r0, long long rows, int k0, int d,
                                           float (*tile)[BM + PAD]) {
  const int r = threadIdx.x / 4;
  const int kq = (threadIdx.x % 4) * 4;
  const long long row = r0 + r;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (row < rows) {
    const float* p = src + row * stride + k0 + kq;
    if (VEC == 4) {
      if (k0 + kq < d) {  // d % 4 == 0: the whole quad is in range
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + kq + e < d) v[e] = __ldg(p + e);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) tile[kq + e][r] = v[e];
}

template <int VEC>
__global__ void __launch_bounds__(ASSIGN_THREADS)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                         const float* __restrict__ cn, int* __restrict__ codes,
                         float* __restrict__ mins, long long n, int k, int d, long long sxb,
                         long long sxn) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float cs[BK][BN + PAD];
  const int bt = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BM;
  const float* xb = x + bt * sxb;
  const float* cb = c + (long long)bt * k * d;
  const float* cnb = cn + (long long)bt * k;
  const int tx = threadIdx.x % (BN / TN);  // centroid quad
  const int ty = threadIdx.x / (BN / TN);  // row quad

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = INT_MAX;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      stage_tile<VEC>(xb, sxn, row0, n, k0, d, xs);
      stage_tile<VEC>(cb, d, c0, k, k0, d, cs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this tile's scores into the running (min, argmin), ascending j
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * TN + j;
      if (col < k) {
        const float cnv = __ldg(cnb + col);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = fmaf(-2.f, acc[i][j], cnv);
          if (lex_less(s, col, best[i], bidx[i])) {
            best[i] = s;
            bidx[i] = col;
          }
        }
      }
    }
  }

  // the 16 threads of a row quad are one half-warp: reduce across it
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best[i];
    int id = bidx[i];
#pragma unroll
    for (int off = BN / TN / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      if (lex_less(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    const long long row = row0 + ty * TM + i;
    if (tx == 0 && row < n) {
      codes[(long long)bt * n + row] = id == INT_MAX ? 0 : id;
      mins[(long long)bt * n + row] = v;
    }
  }
}

}  // namespace

extern "C" {

// x: B problems of n rows, element (b, i, j) at x[b * sxb + i * sxn + j];
// c: (B, k, d) contiguous; cn: (B, k) centroid squared norms; codes (B, n)
// int32 and mins (B, n) f32 out. vec: 4 when d, both strides and both base
// pointers are 16-byte multiples, else 1. Returns the cudaError_t of the
// launch (0 = success).
int ise_kmeans_assign(const void* x, const void* c, const void* cn, void* codes, void* mins,
                      int nb, long long n, int k, int d, long long sxb, long long sxn, int vec,
                      void* stream) {
  const long long tiles = (n + BM - 1) / BM;
  if (tiles > 0x7fffffffLL || nb > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(c);
  const float* cnf = static_cast<const float*>(cn);
  int* co = static_cast<int*>(codes);
  float* mo = static_cast<float*>(mins);
  if (vec == 4) {
    kmeans_assign_kernel<4><<<grid, ASSIGN_THREADS, 0, s>>>(xf, cf, cnf, co, mo, n, k, d, sxb,
                                                            sxn);
  } else if (vec == 1) {
    kmeans_assign_kernel<1><<<grid, ASSIGN_THREADS, 0, s>>>(xf, cf, cnf, co, mo, n, k, d, sxb,
                                                            sxn);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
