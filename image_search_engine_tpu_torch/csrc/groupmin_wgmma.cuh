// A bf16 group-min sweep on Hopper's warpgroup MMA (sm_90a): for each query
// and each 128-row group of the store, the min over the group of norms[r] -
// 2 q.x[r] (score_of), bf16 query and store, f32 sums, rows past n +inf. An
// output policy (Epi) writes the mins; the chunked prototype's
// (groupmin_chunked_wgmma.cu, ChunkedMins) is the only one so far.
//
// What bounds it: the 2 Q N d products (0.53 ms at Q = 2048, N = 1M, d = 128
// at the bf16 tensor-core peak), with the store read from L2 once per query
// tile. The design keeps the tensor cores busy while the CUDA cores take the
// mins:
//
//   * a block takes a query tile of BQ = 128 MT queries (MT 64-row M tiles
//     per consumer warpgroup) and a slice of gps groups. One producer thread
//     streams the slice with the Tensor Memory Accelerator into a ring of
//     `stages` stages, each a group's 128 rows over kc = 64 KSPANS columns,
//     128-byte swizzled (one 64-column box per span), with full and empty
//     mbarriers; the zero fill pads d to whole stages and the rows past n.
//     The query tile is loaded once, before the ring (RESIDENT), or, where it
//     does not fit beside two stages, streamed in each stage beside the rows.
//   * two consumer warpgroups split the tile's queries and run bf16
//     wgmma.mma_async m64n128k16 on every stage, both operands read from
//     shared memory: queries as A (M), the group's rows as B (N = 128), f32
//     sums in 64 MT registers a thread. A thread holds two queries of each M
//     tile and 32 of the group's rows, so a query's group min is 32 fminf in
//     the thread and two shuffles over its quad.
//   * the two warpgroups run in ping-pong: each issues a stage's products
//     only after the other has committed its products of the stage before
//     (two named barriers hand a token back and forth), so the tensor cores
//     take the stages' products in turn, and while one warpgroup takes the
//     mins of a group (norms loaded, scored, reduced and written), the other
//     warpgroup's product of that group runs on the tensor cores.
//
// A stage is released (its empty mbarrier, one arrival per consumer warp)
// once both warpgroups' products of it are done: wgmma.wait_group 1 after
// the next stage's commit, or 0 at a group's last stage, before its mins.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WG_GROUP = 128;                        // rows per group: the MMA's N
constexpr int WG_SPAN = 64;                          // bf16 columns of one 128-byte swizzle span
constexpr int WG_SPAN_BYTES = 128;
constexpr int WG_X_SPAN = WG_GROUP * WG_SPAN_BYTES;  // a group's rows over one span: 16 KB
constexpr int WG_CONSUMERS = 256;                    // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;       // and the producer warpgroup

// Bytes of one ring stage: the group's rows over kspans spans, and the query
// tile's bq rows over them unless the tile is resident.
__host__ __device__ inline size_t groupmin_wgmma_stage(int bq, int kspans, bool resident) {
  return (size_t)kspans * WG_X_SPAN + (resident ? 0 : (size_t)kspans * bq * WG_SPAN_BYTES);
}

// Dynamic shared memory of a block: 1024 bytes for the swizzle's alignment,
// the resident query tile (bq rows over dp columns), the ring, then the
// stages' full and empty mbarriers and the query tile's.
__host__ __device__ inline size_t groupmin_wgmma_smem(int bq, int dp, int kspans, int stages,
                                                      bool resident) {
  return 1024 + (resident ? (size_t)bq * dp * 2 : 0) +
         (size_t)stages * groupmin_wgmma_stage(bq, kspans, resident) +
         (size_t)(2 * stages + 1) * 8;
}

// ---- output policies ----
//
// put() runs on the lanes holding a finished min: m is query q's min over
// group g, for q < nq.

// The chunked prototype's output: group-major out[g * nq + q].
struct ChunkedMins {
  static __device__ __forceinline__ void put(float* __restrict__ out, int g, int q, int nq, int,
                                             float m) {
    out[(size_t)g * nq + q] = m;
  }
};

__device__ __forceinline__ void wg_token_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_CONSUMERS) : "memory");
}
__device__ __forceinline__ void wg_token_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WG_CONSUMERS) : "memory");
}

// The producer thread: the query tile (RESIDENT: all dp / 64 spans, once, on
// qbar), then the block's ntiles stages, tile i = span group (i % nkc) of
// group g0 + i / nkc, into ring stage i % stages.
template <int MT, int KSPANS, bool RESIDENT>
__device__ __forceinline__ void groupmin_wgmma_produce(uint32_t qtile, uint32_t ring,
                                                       uint32_t full, uint32_t empty,
                                                       uint32_t qbar, const CUtensorMap* xmap,
                                                       const CUtensorMap* qmap, int q0, int g0,
                                                       int nkc, int ntiles, int stages) {
  constexpr uint32_t Q_SPAN = 128 * MT * WG_SPAN_BYTES;  // the query tile over one span
  const uint32_t stage_bytes = (uint32_t)groupmin_wgmma_stage(128 * MT, KSPANS, RESIDENT);
  if constexpr (RESIDENT) {
    mbar_expect_tx(qbar, (uint32_t)nkc * KSPANS * Q_SPAN);
    for (int sp = 0; sp < nkc * KSPANS; ++sp)
      tma_load_2d(qtile + sp * Q_SPAN, qmap, qbar, sp * WG_SPAN, q0);
  }
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % stages;
    if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
    const uint32_t st = ring + s * stage_bytes;
    const int row0 = (g0 + i / nkc) * WG_GROUP;
    const int k0 = (i % nkc) * KSPANS * WG_SPAN;
    mbar_expect_tx(full + 8 * s, stage_bytes);
#pragma unroll
    for (int sp = 0; sp < KSPANS; ++sp)
      tma_load_2d(st + sp * WG_X_SPAN, xmap, full + 8 * s, k0 + sp * WG_SPAN, row0);
    if constexpr (!RESIDENT) {
#pragma unroll
      for (int sp = 0; sp < KSPANS; ++sp)
        tma_load_2d(st + KSPANS * WG_X_SPAN + sp * Q_SPAN, qmap, full + 8 * s,
                    k0 + sp * WG_SPAN, q0);
    }
  }
}

// This warp is done reading ring stage s.
__device__ __forceinline__ void wg_release(uint32_t empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * s);
}

// The two consumer warpgroups (threads 0 .. WG_CONSUMERS - 1): warpgroup wg
// multiplies the tile's queries wg * 64 MT .. + 64 MT - 1 by every stage's
// rows and, at each group's last stage, writes the group's mins through Epi.
template <int MT, int KSPANS, bool RESIDENT, class Epi>
__device__ __forceinline__ void groupmin_wgmma_consume(uint32_t qtile, uint32_t ring,
                                                       uint32_t full, uint32_t empty,
                                                       uint32_t qbar, const float* norms,
                                                       float* out, int nq, long long n,
                                                       int ngroups, int q0, int g0, int nkc,
                                                       int ntiles, int stages) {
  constexpr int BQ = 128 * MT;
  constexpr uint32_t Q_SPAN = BQ * WG_SPAN_BYTES;
  const uint32_t stage_bytes = (uint32_t)groupmin_wgmma_stage(BQ, KSPANS, RESIDENT);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  // this warpgroup's first query row of a span of the tile, in bytes (M
  // tiles of 64 rows are 8 swizzle atoms of 1024 bytes)
  const uint32_t arow = (uint32_t)wg * MT * 64 * WG_SPAN_BYTES;
  float acc[MT][WG_GROUP / 2];
  if constexpr (RESIDENT) mbar_wait(qbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % stages;
    const int c = i % nkc;
    mbar_wait(full + 8 * s, (i / stages) & 1);
    if (wg == 1 || i > 0) wg_token_wait(1 + wg);  // the other warpgroup's stage i - wg is issued
    const uint32_t st = ring + s * stage_bytes;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < WG_GROUP / 2; ++e) fence_operand(acc[mt][e]);
    wgmma_fence();
#pragma unroll
    for (int sp = 0; sp < KSPANS; ++sp) {
      const uint32_t a0 =
          (RESIDENT ? qtile + (uint32_t)(c * KSPANS + sp) * Q_SPAN
                    : st + KSPANS * WG_X_SPAN + sp * Q_SPAN) + arow;
#pragma unroll
      for (int kk = 0; kk < WG_SPAN / 16; ++kk) {
        const uint64_t db = wgmma_desc_sw128(st + sp * WG_X_SPAN + kk * MMA_KBYTES);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_bf16<WG_GROUP>(
              acc[mt], wgmma_desc_sw128(a0 + mt * 64 * WG_SPAN_BYTES + kk * MMA_KBYTES), db,
              c > 0 || sp > 0 || kk > 0);
      }
    }
    wgmma_commit();
    if (wg == 0 || i + 1 < ntiles) wg_token_pass(2 - wg);
    if (c > 0) {  // the stage before is done: release it
      wgmma_wait<1>();
      wg_release(empty, (i - 1) % stages, lane);
    }
    if (c < nkc - 1) continue;

    // the group's last stage: its rows' norms (+inf past n, where the zero
    // fill's rows sum to 0) while the products finish, then its mins
    const int g = g0 + i / nkc;
    const long long row0 = (long long)g * WG_GROUP;
    float nv[WG_GROUP / 4];
#pragma unroll
    for (int j = 0; j < WG_GROUP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long row = row0 + 8 * j + 2 * (lane & 3) + e;
        nv[2 * j + e] = row < n ? __ldg(norms + row) : INFINITY;
      }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < WG_GROUP / 2; ++e) fence_operand(acc[mt][e]);
    wg_release(empty, s, lane);
    // acc[mt][4 j + 2 h + e]: query 16 warp + lane / 4 + 8 h of M tile mt,
    // row 8 j + 2 (lane % 4) + e of the group
    float mn[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = INFINITY;
#pragma unroll
        for (int j = 0; j < WG_GROUP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            m = fminf(m, score_of(nv[2 * j + e], acc[mt][4 * j + 2 * h + e]));
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        mn[mt][h] = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + (wg * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * h;
          if (q < nq) Epi::put(out, g, q, nq, ngroups, mn[mt][h]);
        }
    }
  }
}

// Block b takes query tile b % nqt (BQ = 128 MT queries) and the slice of
// gps groups b / nqt; nkc stages of 64 KSPANS columns make a group's rows.
template <int MT, int KSPANS, bool RESIDENT, class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
    groupmin_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const float* __restrict__ norms, float* __restrict__ out, int nq,
                          long long n, int ngroups, int nqt, int gps, int nkc, int stages) {
  constexpr int BQ = 128 * MT;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t qtile = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t ring = qtile + (RESIDENT ? (uint32_t)nkc * KSPANS * BQ * WG_SPAN_BYTES : 0);
  const uint32_t full =
      ring + (uint32_t)stages * (uint32_t)groupmin_wgmma_stage(BQ, KSPANS, RESIDENT);
  const uint32_t empty = full + 8 * stages;
  const uint32_t qbar = empty + 8 * stages;
  const int q0 = (int)(blockIdx.x % nqt) * BQ;
  const int g0 = (int)(blockIdx.x / nqt) * gps;
  const int ntiles = (min(g0 + gps, ngroups) - g0) * nkc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's arrival
      mbar_init(empty + 8 * s, WG_CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier

  if (threadIdx.x >= WG_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG_CONSUMERS)
      groupmin_wgmma_produce<MT, KSPANS, RESIDENT>(qtile, ring, full, empty, qbar, &xmap, &qmap,
                                                   q0, g0, nkc, ntiles, stages);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  groupmin_wgmma_consume<MT, KSPANS, RESIDENT, Epi>(qtile, ring, full, empty, qbar, norms, out,
                                                    nq, n, ngroups, q0, g0, nkc, ntiles, stages);
}

template <int MT, int KSPANS, bool RESIDENT, class Epi>
cudaError_t launch_groupmin_wgmma(const CUtensorMap& xmap, const CUtensorMap& qmap,
                                  const void* norms, void* out, int nq, long long n, int d,
                                  int gps, int stages, size_t smem, cudaStream_t stream) {
  constexpr int BQ = 128 * MT;
  constexpr int KC = KSPANS * WG_SPAN;
  const int ngroups = (int)((n + WG_GROUP - 1) / WG_GROUP);
  const int nqt = (nq + BQ - 1) / BQ;
  const int nkc = (d + KC - 1) / KC;
  const long long grid = (long long)((ngroups + gps - 1) / gps) * nqt;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  if (smem < groupmin_wgmma_smem(BQ, nkc * KC, KSPANS, stages, RESIDENT))
    return cudaErrorInvalidValue;
  auto kernel = groupmin_wgmma_kernel<MT, KSPANS, RESIDENT, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, WG_THREADS, smem, stream>>>(
      xmap, qmap, static_cast<const float*>(norms), static_cast<float*>(out), nq, n, ngroups, nqt,
      gps, nkc, stages);
  return cudaGetLastError();
}

template <int MT, class Epi>
cudaError_t groupmin_wgmma_mt(const CUtensorMap& xmap, const CUtensorMap& qmap, const void* norms,
                              void* out, int nq, long long n, int d, int kc, int stages, int gps,
                              bool resident, size_t smem, cudaStream_t s) {
#define ISE_WGMMA(KSPANS, RES)                                                                \
  launch_groupmin_wgmma<MT, KSPANS, RES, Epi>(xmap, qmap, norms, out, nq, n, d, gps, stages, \
                                              smem, s)
  if (kc == 128) return resident ? ISE_WGMMA(2, true) : ISE_WGMMA(2, false);
  if (kc == 64) return resident ? ISE_WGMMA(1, true) : ISE_WGMMA(1, false);
  return cudaErrorInvalidValue;
#undef ISE_WGMMA
}

// The sweep on ops/groupmin_variants.py chunked_plan's tiles: a bf16 query
// (nq, d) and store (n, d), rows of d % 8 == 0 elements at 16-byte aligned
// bases (the Tensor Memory Accelerator's rule), f32 norms (n,); bq queries
// per tile (128 or 256), kc columns per stage (64 or 128), `stages` ring
// stages, gps groups per block, resident 1 to load the query tile once,
// smem the dynamic shared memory (at least groupmin_wgmma_smem).
template <class Epi>
cudaError_t groupmin_wgmma(const void* q, const void* norms, const void* x, void* out, int nq,
                           long long n, int d, int bq, int kc, int stages, int gps, int resident,
                           int smem, cudaStream_t s) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  if (nq < 1 || n < 1 || n > (long long)INT_MAX - WG_GROUP || d < 8 || d % 8 != 0 || !aligned ||
      stages < 2 || gps < 1 || !encoder())
    return cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  if (!tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, d, n, WG_SPAN, WG_GROUP,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, d, nq, WG_SPAN, bq,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (bq == 128)
    return groupmin_wgmma_mt<1, Epi>(xmap, qmap, norms, out, nq, n, d, kc, stages, gps,
                                     resident != 0, (size_t)smem, s);
  if (bq == 256)
    return groupmin_wgmma_mt<2, Epi>(xmap, qmap, norms, out, nq, n, d, kc, stages, gps,
                                     resident != 0, (size_t)smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
