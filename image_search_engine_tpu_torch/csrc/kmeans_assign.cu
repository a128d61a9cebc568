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
// Bound: 2*B*N*K*d operations against N*d*4 bytes of points, so at the
// coarse quantizer's shape (N = 1M, K = 1024, d = 2048) the products bound
// it: 62.6 ms at the CUDA cores' f32 rate, where cuBLAS's f32 product alone
// takes ~85 ms. The design moves them onto the tensor cores with a 3xTF32
// split, which keeps f32 accuracy: each f32 operand a is split as a = hi +
// lo, hi = tf32(a), lo = tf32(a - hi), and each 8-deep k-step accumulates
// hi_a.lo_b, then lo_a.hi_b, then hi_a.hi_b into f32. hi + lo is a within
// 2^-22 |a|, and the dropped lo_a.lo_b term is below 2^-22 |a b|, so each
// product keeps about f32's precision, while the three passes cost 3x the
// operations at 7.4x the f32 rate (a 25.4 ms bound at that shape); a single
// tf32 pass would keep 11 bits. The products are Hopper's warpgroup MMA
// (wgmma m64n128k8 tf32): the centroids come split by the wrapper (hi and
// lo, ops/kmeans.tf32_split) and are read from shared memory; the points
// are split in registers (tf32_split, mma.cuh), each exactly once, since
// every point row belongs to one warp.
//
// A block owns BM = 256 points of one problem and walks all K centroids in
// BN = 128-wide tiles, BK = 32 columns at a time. The points are re-read
// for every centroid tile (8 times at K = 1024) and the centroid halves once
// per block, 129 GB at the coarse shape, so the copies pace the products
// unless they run apart: one producer warpgroup's thread streams each stage
// (the points' and both centroid halves' tiles) into a three-stage ring
// with the Tensor Memory Accelerator, 128-byte swizzled, as the wgmma reads
// them, zero-filling rows past n or k and columns past d (zeros add exactly
// 0); mbarriers hand the stages to the two consumer warpgroups and back, so
// no block-wide barrier holds the tensor cores. A consumer warpgroup owns
// 128 of the points as two 64-row wgmma tiles: per stage it loads its
// fragments with ldmatrix, splits them, issues 24 wgmmas as one group and
// releases the stage when they are done. After a centroid tile's last
// stage each thread folds its scores, fmaf(-2, dot, |c|^2), into a running
// (min, argmin) per point in registers, in ascending centroid order with
// ties to the lowest index; at the end the four lanes of a quad, which hold
// one point's columns, reduce the pairs the same way. The (N, K) distances
// never reach device memory, which is what the TPU kernel keeps out of HBM.
// The batch dimension (grid y) covers the product quantizer's m codebooks in
// one launch.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 256;   // points per block: 128 per consumer warpgroup
constexpr int BN = 128;   // centroids per tile: the wgmma's N
constexpr int BK = SW128_COLS;  // f32 columns per stage: 128 bytes, one swizzle span
constexpr int KSTEPS = BK / 8;
constexpr int MT = 2;     // 64-row tiles per consumer warpgroup
constexpr int STAGES = 3;
constexpr int CONSUMER_THREADS = 256;  // two warpgroups
constexpr int ASSIGN_THREADS = CONSUMER_THREADS + 128;  // and the producer warpgroup
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;  // one centroid half
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
// the ring (1024-byte aligned, the swizzle's period), then the stages' full
// and empty mbarriers
constexpr size_t ASSIGN_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(ASSIGN_THREADS, 1)
    kmeans_assign_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap himap,
                         const __grid_constant__ CUtensorMap lomap, const float* __restrict__ cn,
                         int* __restrict__ codes, float* __restrict__ mins, long long n, int k,
                         int d, bool rows_first) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;
  const int bt = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BM;
  const int nkc = max(1, (d + BK - 1) / BK);  // d = 0: one zero chunk, scores |c|^2
  const int ntiles = nkc * ((k + BN - 1) / BN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                        // the producer's arrival
      mbar_init(empty + 8 * s, CONSUMER_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMER_THREADS) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t st = ring + s * STAGE_BYTES;
        const int c0 = (i / nkc) * BN;
        const int k0 = (i % nkc) * BK;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        if (rows_first)
          tma_load_3d(st, &xmap, full + 8 * s, k0, (int)row0, bt);
        else
          tma_load_3d(st, &xmap, full + 8 * s, k0, bt, (int)row0);
        tma_load_3d(st + A_BYTES, &himap, full + 8 * s, k0, c0, bt);
        tma_load_3d(st + A_BYTES + B_BYTES, &lomap, full + 8 * s, k0, c0, bt);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const float* cnb = cn + (long long)bt * k;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = (int)min((long long)BM, n - row0);
  // warpgroup g = w / 4 multiplies point rows 128 g + 64 t .. + 63 (tile t);
  // warp w holds the accumulators of its 16 rows wrow + 64 t .. + 15. In the
  // swizzle, 16-byte chunk c of row r sits at r * 128 + ((c ^ (r % 8)) * 16),
  // and r % 8 = lane % 8 for this lane's ldmatrix row.
  const int wrow = (warp / 4) * 128 + (warp % 4) * 16;
  const uint32_t arow = (uint32_t)(wrow + (lane & 15)) * 128;
  const int achunk = lane >> 4;

  // running (min, argmin) of the points in rows wrow + 64 t + lane / 4 + 8 h
  // over this thread's columns
  float best[MT][2];
  int bidx[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[t][h] = INFINITY;
      bidx[t][h] = INT_MAX;
    }
  float acc[MT][64];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[t][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t st = ring + s * STAGE_BYTES;
    // the points' fragments split and the descriptors made before the group,
    // so nothing but wgmmas runs between its fence and its commit
    uint32_t ah[MT][KSTEPS][4], al[MT][KSTEPS][4];
    uint64_t dh[KSTEPS], dl[KSTEPS];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t chunk = (uint32_t)(((2 * kk + achunk) ^ (lane & 7)) << 4);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        uint32_t r[4];
        ldmatrix_x4(st + arow + t * 64 * 128 + chunk, r);
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(r[e], ah[t][kk][e], al[t][kk][e]);
      }
      dh[kk] = wgmma_desc_sw128(st + A_BYTES + kk * MMA_KBYTES);
      dl[kk] = wgmma_desc_sw128(st + A_BYTES + B_BYTES + kk * MMA_KBYTES);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[t][e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int t = 0; t < MT; ++t) {  // the small terms of each k-step first
        wgmma_tf32<BN>(acc[t], ah[t][kk], dl[kk], 1);
        wgmma_tf32<BN>(acc[t], al[t][kk], dh[kk], 1);
        wgmma_tf32<BN>(acc[t], ah[t][kk], dh[kk], 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[t][e]);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(ah[t][kk][e]);
          fence_operand(al[t][kk][e]);
        }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage

    if (i % nkc == nkc - 1) {  // the centroid tile's last chunk: fold its scores
      const int c0 = (i / nkc) * BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + e;
          if (col < k) {
            const float cnv = __ldg(cnb + col);
#pragma unroll
            for (int t = 0; t < MT; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float sc = fmaf(-2.f, acc[t][4 * j + 2 * h + e], cnv);
                if (lex_less(sc, col, best[t][h], bidx[t][h])) {
                  best[t][h] = sc;
                  bidx[t][h] = col;
                }
              }
          }
        }
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[t][e] = 0.f;
    }
  }

  // the quad's four lanes hold one point's columns
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[t][h];
      int id = bidx[t][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, id, off);
        if (lex_less(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      const int r = wrow + 64 * t + 8 * h + (lane >> 2);
      if ((lane & 3) == 0 && r < rows) {
        codes[(long long)bt * n + row0 + r] = id == INT_MAX ? 0 : id;
        mins[(long long)bt * n + row0 + r] = v;
      }
    }
}

}  // namespace

extern "C" {

// x: B problems of n rows, element (b, i, j) at x[b * sxb + i * sxn + j];
// chi, clo: (B, k, d) contiguous, the centroids' tf32 halves (hi = tf32(c),
// lo = tf32(c - hi)); cn: (B, k) centroid squared norms; codes (B, n) int32
// and mins (B, n) f32 out. d, sxn and sxb must be multiples of 4 and every
// pointer 16-byte aligned (the Tensor Memory Accelerator's rule; the wrapper
// pads d). Returns the cudaError_t of the launch (0 = success).
int ise_kmeans_assign(const void* x, const void* chi, const void* clo, const void* cn,
                      void* codes, void* mins, int nb, long long n, int k, int d, long long sxb,
                      long long sxn, void* stream) {
  const long long tiles = (n + BM - 1) / BM;
  if (tiles > 0x7fffffffLL || nb < 1 || nb > 65535 || n < 1 || k < 1)
    return cudaErrorInvalidConfiguration;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(chi) |
                        reinterpret_cast<uintptr_t>(clo)) % 16 == 0;
  if (d < 4 || d % 4 || sxn % 4 || sxb % 4 || !aligned || !encoder())
    return cudaErrorInvalidValue;
  // the points' map takes its dimensions in ascending stride (the PQ books'
  // (m, N, dsub) view has the batch innermost): rows then batches, or
  // batches then rows; either way a box is 256 rows of one problem
  CUtensorMap xmap, himap, lomap;
  const bool rows_first = nb == 1 || sxn <= sxb;
  const long long cstride = (long long)k * d;
  if (!(rows_first ? tensor_map(&xmap, x, d, n, sxn, BM, nb, nb > 1 ? sxb : n * sxn, 1)
                   : tensor_map(&xmap, x, d, nb, sxb, 1, n, sxn, BM)) ||
      !tensor_map(&himap, chi, d, k, d, BN, nb, cstride, 1) ||
      !tensor_map(&lomap, clo, d, k, d, BN, nb, cstride, 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ASSIGN_SMEM);
  if (err != cudaSuccess) return err;
  kmeans_assign_kernel<<<dim3((unsigned)tiles, (unsigned)nb), ASSIGN_THREADS, ASSIGN_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      xmap, himap, lomap, static_cast<const float*>(cn), static_cast<int*>(codes),
      static_cast<float*>(mins), n, k, d, rows_first);
  return cudaGetLastError();
}

}  // extern "C"
