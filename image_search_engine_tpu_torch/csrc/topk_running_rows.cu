// Exact top-k with running accumulators for Hopper (sm_90a), a lane per row,
// with a plain C interface for ctypes (ops/_kernels.py builds this file;
// ops/topk.py holds the wrapper, topk_running, its plan, running_plan, and
// its plain PyTorch version, topk_running_ref).
//
// Replaces image_search_engine_tpu/ops/topk_pallas.py _topk_kernel (via
// topk_pallas). There one TPU core walks the store tile by tile, keeps a (Q,
// k) accumulator in VMEM scratch across the sequential grid, and merges a
// tile only when its row min beats some query's k-th. Here blocks run in
// parallel and in no order, so the accumulator is split and merged twice:
// block (slice, query tile) keeps per-warp lists of a slice's rows, merges
// them into one list per query, and running_merge_kernel merges the slices'
// lists (running_lists.cuh).
//
// What bounds it on the card: one read of the store per query tile of up to
// 8 queries, N d itemsize + 4 N bytes (2.45 ms over 1M x 2048 f32). Its 2 Q
// N d true f32 products are a fifth of that at Q = 8 on the CUDA cores. The
// kernel it replaced (topk_running.cu, a warp per row) fed those FMAs from
// shared memory, QT query floats for every store float, on the pipe that
// also carried the store's loads, and ended each row with a butterfly per
// query: at Q = 8 it reached 41% of the bound. Here:
//
//   * a producer warp streams the slice with the Tensor Memory Accelerator
//     into a ring of `stages` stages, each 256 rows x 128 bytes of them (32
//     f32 or 64 bf16 columns), 128-byte swizzled, with full and empty
//     mbarriers: the bytes in flight are the ring's, whatever the query tile
//     leaves of the SM. Rows past n and columns past d arrive as zeros. Rows
//     whose length or base is not a multiple of 16 bytes, which the Tensor
//     Memory Accelerator cannot tile, are copied by the producer warp
//     element by element into the same layout.
//   * each of the 8 consumer warps takes 32 of a stage's rows, a lane per
//     row: the lane reads its row's 16-byte chunks (the swizzle puts 8
//     neighbouring lanes' chunks on 8 different bank groups, so a warp's
//     read takes the 4 wavefronts of its 512 bytes) and, for each, every
//     query's 4 or 8 floats as one broadcast read, so one wavefront feeds 32
//     lanes' FMAs. The lane sums its row for all QT queries over the row's
//     spans; no shuffle sums a row.
//   * after a tile's last span each lane holds its row's QT scores: per
//     query, a ballot of the 32 lanes against the warp's k-th pair picks the
//     rows that enter the warp's list (list_offer).
//
// The f32 sums run in another order than the replaced kernel's, each product
// a true f32 FMA; bf16 rows are widened exactly. The query stays f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "running_lists.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int ROWS_WARPS = 8;                          // consumer warps
constexpr int ROWS_TILE = ROWS_WARPS * 32;             // rows per stage: a lane each
constexpr int ROWS_THREADS = ROWS_TILE + 32;           // and the producer warp
constexpr int ROWS_SPAN = 128;                         // bytes of a row per stage
constexpr int ROWS_STAGE = ROWS_TILE * ROWS_SPAN;      // 32 KB
constexpr int ROWS_MAX_STAGES = 8;
constexpr int ROWS_BARS = 2 * ROWS_MAX_STAGES * 8;     // the mbarriers, at the head

// Dynamic shared memory of a block: the mbarriers, 1024 bytes for the
// swizzle's alignment, the ring and the f32 query tile (qt rows of dpad),
// which the warps' lists (8 x qt x k pairs) reuse after the scan.
__host__ __device__ inline size_t running_rows_smem(int qt, int dpad, int stages, int k) {
  const size_t scan = (size_t)stages * ROWS_STAGE + (size_t)qt * dpad * 4;
  const size_t lists = (size_t)ROWS_WARPS * qt * k * 8;
  return ROWS_BARS + 1024 + (scan > lists ? scan : lists);
}

__device__ __forceinline__ void rows_consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(ROWS_TILE) : "memory");
}

// the 16 bytes of a row chunk as f32: 4 f32, or 8 bf16 widened exactly
__device__ __forceinline__ void widen(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Block (slice, query tile): rows [slice * rows_per_slice, ...) against
// queries [tile * QT, ...) in tiles of 256 rows, each over dpad / (128 /
// itemsize) stages. part_v/part_i[(q * nslices + slice) * k + p].
template <typename T, int QT, int E>
__global__ void __launch_bounds__(ROWS_THREADS, QT <= 4 ? 2 : 1)
    running_rows_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ q,
                        const float* __restrict__ norms, const T* __restrict__ x,
                        float* __restrict__ part_v, int* __restrict__ part_i, int nq,
                        long long n, int d, int dpad, int k, int nslices,
                        long long rows_per_slice, int stages, int tma) {
  using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
  constexpr int ELEMS = ROWS_SPAN / (int)sizeof(T);  // row elements per stage
  constexpr int VEC = 16 / (int)sizeof(T);           // per 16-byte chunk
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const uint32_t full = smem_u32(rows_smem);
  const uint32_t empty = full + 8 * ROWS_MAX_STAGES;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(rows_smem) + ROWS_BARS + 1023) & ~uintptr_t(1023));
  float* qs = reinterpret_cast<float*>(ring + (size_t)stages * ROWS_STAGE);
  const int slice = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const long long r0 = (long long)slice * rows_per_slice;
  const long long r1 = r0 + rows_per_slice < n ? r0 + rows_per_slice : n;
  const int ntiles = r1 > r0 ? (int)((r1 - r0 + ROWS_TILE - 1) / ROWS_TILE) : 0;
  const int nspans = dpad / ELEMS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : 32);  // the copy's arrival, or each producer lane's
      mbar_init(empty + 8 * s, ROWS_WARPS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile as f32, zero past d and past nq
  for (int i = threadIdx.x; i < QT * dpad; i += ROWS_THREADS) {
    const int qi = i / dpad;
    const int j = i - qi * dpad;
    qs[i] = (q0 + qi < nq && j < d) ? q[(size_t)(q0 + qi) * d + j] : 0.f;
  }
  __syncthreads();  // the last block-wide barrier

  if (warp == ROWS_WARPS) {  // the producer warp: stage i is span i % nspans of tile i / nspans
    for (int i = 0; i < ntiles * nspans; ++i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
      unsigned char* st = ring + (size_t)s * ROWS_STAGE;
      const long long row0 = r0 + (long long)(i / nspans) * ROWS_TILE;
      const int c0 = (i % nspans) * ELEMS;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, ROWS_STAGE);
          tma_load_2d(smem_u32(st), &xmap, full + 8 * s, c0, (int)row0);
        }
        continue;
      }
      // element by element, in the swizzle the Tensor Memory Accelerator
      // writes (16-byte chunk j of row r at chunk j ^ (r % 8))
      const Raw* xr = reinterpret_cast<const Raw*>(x);
      for (int r = 0; r < ROWS_TILE; ++r) {
        const long long row = row0 + r;
        for (int e = lane; e < ELEMS; e += 32) {
          const int byte = e * (int)sizeof(T);
          *reinterpret_cast<Raw*>(st + r * ROWS_SPAN + ((((byte >> 4) ^ (r & 7)) << 4) |
                                                        (byte & 15))) =
              row < n && c0 + e < d ? xr[row * d + c0 + e] : Raw(0);
        }
      }
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // the consumer warps: lane `lane` of warp `warp` scores row r of each tile
  const int r = warp * 32 + lane;
  float v[QT][E];
  int id[QT][E];
  float tv[QT];
  int ti[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    list_init<E>(v[qi], id[qi]);
    tv[qi] = INFINITY;
    ti[qi] = -1;
  }
  for (int t = 0; t < ntiles; ++t) {
    const long long row = r0 + (long long)t * ROWS_TILE + r;
    const bool ok = row < r1;
    const float nr = ok ? __ldg(norms + row) : 0.f;
    float acc[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) acc[qi] = 0.f;
    for (int c = 0; c < nspans; ++c) {
      const int i = t * nspans + c;
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const unsigned char* rp = ring + (size_t)s * ROWS_STAGE + r * ROWS_SPAN;
      const float* qp = qs + c * ELEMS;
      // two chunks at a time: unrolled whole, the 8-query tile's loads of a
      // span filled its 168 registers and spilled
#pragma unroll 2
      for (int j = 0; j < ROWS_SPAN / 16; ++j) {
        float xv[VEC];
        widen(*reinterpret_cast<const uint4*>(rp + ((j ^ (r & 7)) << 4)), xv);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi)
#pragma unroll
          for (int h = 0; h < VEC / 4; ++h) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qp + (size_t)qi * dpad + j * VEC + 4 * h);
            acc[qi] = fmaf(qv.x, xv[4 * h], acc[qi]);
            acc[qi] = fmaf(qv.y, xv[4 * h + 1], acc[qi]);
            acc[qi] = fmaf(qv.z, xv[4 * h + 2], acc[qi]);
            acc[qi] = fmaf(qv.w, xv[4 * h + 3], acc[qi]);
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }
    // the tile's rows against each query's k-th: rows past the slice offer
    // (+inf, INT_MAX), which no list pair exceeds
#pragma unroll
    for (int qi = 0; qi < QT; ++qi)
      if (q0 + qi < nq)
        list_offer<E>(v[qi], id[qi], tv[qi], ti[qi], ok ? score_of(nr, acc[qi]) : INFINITY,
                      ok ? (int)row : INT_MAX, k, lane);
  }

  rows_consumer_barrier();  // the ring and the query tile are dead: they hold the lists now
  float* lv = reinterpret_cast<float*>(ring);                        // [ROWS_WARPS][QT][k]
  int* li = reinterpret_cast<int*>(lv + (size_t)ROWS_WARPS * QT * k);  // the same, ids
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    const size_t at = (size_t)(warp * QT + qi) * k;
    list_store<E>(v[qi], id[qi], lv + at, li + at, k, lane);
  }
  rows_consumer_barrier();
  // warp w merges query w's ROWS_WARPS lists
  if (warp < QT && q0 + warp < nq) {
    float mv[E];
    int mi[E];
    float mtv = INFINITY;
    int mti = -1;
    list_init<E>(mv, mi);
    for (int w = 0; w < ROWS_WARPS; ++w) {
      const size_t at = (size_t)(w * QT + warp) * k;
      list_merge_from<E>(mv, mi, mtv, mti, lv + at, li + at, 0, k, 32, k, lane);
    }
    const size_t out = ((size_t)(q0 + warp) * nslices + slice) * k;
    list_store<E>(mv, mi, part_v + out, part_i + out, k, lane);
  }
}

template <typename T, int QT, int E>
cudaError_t launch_rows(const CUtensorMap& xmap, const void* q, const void* norms, const void* x,
                        void* part_v, void* part_i, void* out_v, void* out_i, int nq, long long n,
                        int d, int dpad, int k, int nslices, long long rows_per_slice, int stages,
                        size_t smem, int tma, cudaStream_t stream) {
  const int nqt = (nq + QT - 1) / QT;
  auto scan = running_rows_kernel<T, QT, E>;
  cudaError_t err =
      cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scan<<<dim3((unsigned)nslices, (unsigned)nqt), ROWS_THREADS, smem, stream>>>(
      xmap, static_cast<const float*>(q), static_cast<const float*>(norms),
      static_cast<const T*>(x), static_cast<float*>(part_v), static_cast<int*>(part_i), nq, n, d,
      dpad, k, nslices, rows_per_slice, stages, tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  running_merge_kernel<E><<<nq, MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), nslices, k);
  return cudaGetLastError();
}

template <typename T, int QT>
cudaError_t rows_k(const CUtensorMap& xmap, const void* q, const void* norms, const void* x,
                   void* part_v, void* part_i, void* out_v, void* out_i, int nq, long long n,
                   int d, int dpad, int k, int nslices, long long rps, int stages, size_t smem,
                   int tma, cudaStream_t s) {
#define ISE_ROWS(E)                                                                           \
  launch_rows<T, QT, E>(xmap, q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, dpad, k, \
                        nslices, rps, stages, smem, tma, s)
  if (k <= 32) return ISE_ROWS(1);
  if (k <= 64) return ISE_ROWS(2);
  return ISE_ROWS(4);
#undef ISE_ROWS
}

template <typename T>
cudaError_t rows_qt(const void* q, const void* norms, const void* x, void* part_v, void* part_i,
                    void* out_v, void* out_i, int nq, long long n, int d, int k, int qt,
                    int nslices, long long rps, int stages, int smem, int tma, cudaStream_t s) {
  constexpr int ELEMS = ROWS_SPAN / (int)sizeof(T);
  const int dpad = (d + ELEMS - 1) / ELEMS * ELEMS;
  if (stages < 2 || stages > ROWS_MAX_STAGES ||
      (size_t)smem < running_rows_smem(qt, dpad, stages, k))
    return cudaErrorInvalidValue;
  CUtensorMap xmap = {};
  if (tma) {
    const CUtensorMapDataType type =
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if ((d * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        !tensor_map_2d(&xmap, type, (int)sizeof(T), x, d, n, ELEMS, ROWS_TILE,
                       CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
#define ISE_ROWS_QT(QT)                                                                       \
  rows_k<T, QT>(xmap, q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, dpad, k, nslices, \
                rps, stages, (size_t)smem, tma, s)
  switch (qt) {
    case 1: return ISE_ROWS_QT(1);
    case 2: return ISE_ROWS_QT(2);
    case 4: return ISE_ROWS_QT(4);
    case 8: return ISE_ROWS_QT(8);
    default: return cudaErrorInvalidValue;
  }
#undef ISE_ROWS_QT
}

}  // namespace

extern "C" {

// dtype: 0 = float32 store, 1 = bfloat16 store; the query q is float32 either
// way. qt: queries per scan block (1, 2, 4 or 8); nslices slices of
// rows_per_slice rows; stages: ring stages (2 to 8); smem: the scan block's
// dynamic shared memory (at least running_rows_smem); tma 1 for rows the
// Tensor Memory Accelerator can tile (d * itemsize % 16 == 0, x 16-byte
// aligned), else 0. part_v/part_i: (nq, nslices, k) scratch; out_v/out_i:
// (nq, k), ascending in (score, id). 1 <= k <= 128, 0 <= n < 2^31. Returns the
// cudaError_t of the two launches (0 = success). ops/topk.py running_plan
// gives qt, nslices, rows_per_slice, stages and smem.
int ise_topk_running_rows(int dtype, const void* q, const void* norms, const void* x,
                          void* part_v, void* part_i, void* out_v, void* out_i, int nq,
                          long long n, int d, int k, int qt, int nslices,
                          long long rows_per_slice, int stages, int smem, int tma, void* stream) {
  if (k < 1 || k > MAX_K || nslices < 1 || rows_per_slice < 1 || n < 0 || n >= INT32_MAX ||
      d < 1 || (long long)nslices * rows_per_slice < n)
    return cudaErrorInvalidValue;
  if (n == 0) tma = 0;  // no rows to tile: every list stays (+inf, -1)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rows_qt<float>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k, qt, nslices,
                          rows_per_slice, stages, smem, tma, s);
  if (dtype == 1)
    return rows_qt<__nv_bfloat16>(q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k, qt,
                                  nslices, rows_per_slice, stages, smem, tma, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
