// The f32 store's phase 1 (group-min sweep) and phase 2 (rescore) on
// Hopper's warpgroup MMA, with a 3xTF32 split, for batches beyond a few
// queries (ops/topk.py F32_CUDA_CORE_MAX_Q) over rows the Tensor Memory
// Accelerator can tile (d a multiple of 4, 16-byte aligned). Plain C
// interface for ctypes (ops/_kernels.py builds it; ops/topk.py groupmin and
// rescore are the wrappers). It replaces
// image_search_engine_tpu/ops/topk_pallas.py _groupmin_kernel and
// _fused_rescore_kernel (f32 at Precision.HIGHEST): for each query and each
// 128-row group of the store, the min over the group of norms[r] - 2
// q.x[r]; for each (query, candidate group), the group's 128 scores.
//
// Bound of the sweep: the store's 4 N d bytes, and 3 x 2 Q N d tf32
// operations for the split (Q = 64 over 1M x 2048: 2.45 ms of bytes, 1.59
// ms of operations at 495 TF/s). mma.sync's tf32 path tops out far below
// that rate on the H100; the warpgroup MMA runs asynchronously beside the
// split and the copies. So the store rows are the MMA's A operand (64 rows
// per consumer warpgroup, from registers: each element loaded with ldmatrix
// and split once, tf32_split in mma.cuh), the queries its B operand (BN per
// block, split by the wrapper with ops/kmeans.tf32_split, the same split,
// read from shared memory). A producer thread streams each 32-column stage
// (the group's 128 rows and both query halves' BN rows) into a four-stage
// ring with the Tensor Memory Accelerator, 128-byte swizzled, zero-filling
// rows past n, queries past nq and columns past d (zeros add exactly 0);
// mbarriers hand the stages to the two consumer warpgroups and back, so no
// block-wide barrier holds the tensor cores. Per stage (4 k-steps) a
// consumer warpgroup sums x_lo.q_hi, x_hi.q_lo, x_hi.q_hi of each k-step,
// in that order, into a zeroed sum on the tensor cores, and one IEEE f32 add
// puts the sum into the row's running dot. The tensor cores' own sums do
// not round to nearest; a running sum of all 3 d / 8 products carried that
// bias along the whole row and went over the search's score tolerance on
// rows of one sign at d = 2048, where sums of one stage stay well within it.
//
// Both phases are this kernel (RESCORE false / true), and phase 2 gives a
// query the query tile (q0 = its tile of BN) and the stages phase 1 gave
// it: each score comes from the same instructions on the same operands in
// the same registers, lanes and order, so a group's phase-1 min is bit for
// bit the min of its phase-2 scores, which keeps the certificate ("k-th
// final score <= t-th selected group min") valid. The price is the rescore's
// products for the tile's other queries, which it discards: BN times the
// products it needs, still under the bytes it reads at BN <= 64.
//
// Phase 1: block b takes query tile b % nqt and the slice of gps groups b /
// nqt. After a group's last stage each thread scores its rows (score_of),
// takes the min over its two rows and, with shuffles, over the warp's 16,
// and the eight consumer warps' mins meet in shared memory (double-buffered,
// one named barrier per group). Phase 2: block b scores the (query,
// candidate group) pair of slot b; the lanes holding the query's column
// write the group's 128 scores to out[b * 128 + r], +inf for rows at or
// past n.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TF32_GROUP = 128;      // rows per group: two consumer warpgroups of 64
constexpr int TF32_STAGES = 4;
constexpr int TF32_CONSUMERS = 256;  // two warpgroups
constexpr int TF32_THREADS = TF32_CONSUMERS + 128;  // and the producer warpgroup
constexpr int TF32_KSTEPS = SW128_COLS / 8;         // k-steps per stage: one sum
constexpr int TF32_A_BYTES = TF32_GROUP * SW128_COLS * 4;

template <int BN>
struct Tf32Layout {
  static constexpr int B_BYTES = BN * SW128_COLS * 4;  // one query half
  static constexpr int STAGE = TF32_A_BYTES + 2 * B_BYTES;
  static constexpr int RED = 2 * (TF32_CONSUMERS / 32) * BN * 4;  // two buffers of warp mins
  // the ring (1024-byte aligned, the swizzle's period), the warp mins, then
  // the stages' full and empty mbarriers
  static constexpr size_t SMEM = 1024 + (size_t)TF32_STAGES * STAGE + RED + 2 * TF32_STAGES * 8;
};

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TF32_CONSUMERS) : "memory");
}

// RESCORE false: phase 1, out (nq, ngroups) of mins, cand unread. RESCORE
// true: phase 2, out (nq * t, 128) of scores for the groups cand (nq, t);
// ngroups, nqt and gps unread.
template <int BN, bool RESCORE>
__global__ void __launch_bounds__(TF32_THREADS, 1)
    flat_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap himap,
                     const __grid_constant__ CUtensorMap lomap, const float* __restrict__ norms,
                     const int* __restrict__ cand, float* __restrict__ out, int nq, long long n,
                     int d, int ngroups, int nqt, int gps, int t) {
  using L = Tf32Layout<BN>;
  constexpr int R = BN / 2;  // accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + TF32_STAGES * L::STAGE);
  const uint32_t full = ring + TF32_STAGES * L::STAGE + L::RED;  // TF32_STAGES 8-byte barriers
  const uint32_t empty = full + TF32_STAGES * 8;
  const long long slot = blockIdx.x;  // phase 2: the (query, candidate) pair
  const int qi = RESCORE ? (int)(slot / t) : 0;
  const int q0 = RESCORE ? qi / BN * BN : (int)(blockIdx.x % nqt) * BN;
  const int g0 = RESCORE ? __ldg(cand + slot) : (int)(blockIdx.x / nqt) * gps;
  const int g1 = RESCORE ? g0 + 1 : min(g0 + gps, ngroups);
  const int nkc = (d + SW128_COLS - 1) / SW128_COLS;
  const int ntiles = (g1 - g0) * nkc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF32_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                       // the producer's arrival
      mbar_init(empty + 8 * s, TF32_CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier

  if (threadIdx.x >= TF32_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == TF32_CONSUMERS) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % TF32_STAGES;
        if (i >= TF32_STAGES) mbar_wait(empty + 8 * s, (i / TF32_STAGES - 1) & 1);
        const uint32_t st = ring + s * L::STAGE;
        const int row0 = (g0 + i / nkc) * TF32_GROUP;
        const int k0 = (i % nkc) * SW128_COLS;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_3d(st, &xmap, full + 8 * s, k0, row0, 0);
        tma_load_3d(st + TF32_A_BYTES, &himap, full + 8 * s, k0, q0, 0);
        tma_load_3d(st + TF32_A_BYTES + L::B_BYTES, &lomap, full + 8 * s, k0, q0, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // warp w multiplies the group's rows wrow .. wrow + 15 (warpgroup w / 4
  // rows 64 (w / 4) ..); in the swizzle, 16-byte chunk c of row r sits at r
  // * 128 + ((c ^ (r % 8)) * 16), and r % 8 = lane % 8 for this lane's
  // ldmatrix row
  const int wrow = warp * 16;
  const uint32_t arow = (uint32_t)(wrow + (lane & 15)) * 128;
  const int achunk = lane >> 4;
  float acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % TF32_STAGES;
    mbar_wait(full + 8 * s, (i / TF32_STAGES) & 1);
    const uint32_t st = ring + s * L::STAGE;
    // the rows' fragments split and the descriptors made before the group,
    // so nothing but wgmmas runs between its fence and its commit
    uint32_t ah[TF32_KSTEPS][4], al[TF32_KSTEPS][4];
    uint64_t dh[TF32_KSTEPS], dl[TF32_KSTEPS];
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(st + arow + (uint32_t)(((2 * kk + achunk) ^ (lane & 7)) << 4), r);
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(r[e], ah[kk][e], al[kk][e]);
      dh[kk] = wgmma_desc_sw128(st + TF32_A_BYTES + kk * MMA_KBYTES);
      dl[kk] = wgmma_desc_sw128(st + TF32_A_BYTES + L::B_BYTES + kk * MMA_KBYTES);
    }
    float sum[R];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      sum[e] = 0.f;
      fence_operand(sum[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk) {
      wgmma_tf32<BN>(sum, al[kk], dh[kk], 1);  // x_lo . q_hi
      wgmma_tf32<BN>(sum, ah[kk], dl[kk], 1);  // x_hi . q_lo
      wgmma_tf32<BN>(sum, ah[kk], dh[kk], 1);  // x_hi . q_hi
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < R; ++e) fence_operand(sum[e]);
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(ah[kk][e]);
        fence_operand(al[kk][e]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = __fadd_rn(acc[e], sum[e]);

    if (i % nkc != nkc - 1) continue;
    // the group's last stage: its scores. This thread holds rows wrow +
    // lane / 4 + 8 h, columns 8 j + 2 (lane % 4) + e in acc[4 j + 2 h + e].
    const int g = g0 + i / nkc;
    float nr[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)g * TF32_GROUP + wrow + (lane >> 2) + 8 * h;
      ok[h] = row < n;
      nr[h] = ok[h] ? __ldg(norms + row) : 0.f;
    }
    if constexpr (RESCORE) {
      const int c = qi - q0;  // the query's column
      if ((lane & 3) == (c & 7) / 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + 2 * (lane & 3) + e == c) dot = acc[4 * j + 2 * h + e];
          out[slot * TF32_GROUP + wrow + (lane >> 2) + 8 * h] =
              ok[h] ? score_of(nr[h], dot) : INFINITY;
        }
      }
    } else {
      float* rb = red + ((i / nkc) & 1) * (TF32_CONSUMERS / 32) * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m = fminf(m, ok[h] ? score_of(nr[h], acc[4 * j + 2 * h + e]) : INFINITY);
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (lane < 4) rb[warp * BN + 8 * j + 2 * lane + e] = m;
        }
      consumer_barrier();
      for (int c = threadIdx.x; c < BN && q0 + c < nq; c += TF32_CONSUMERS) {
        float m = rb[c];
#pragma unroll
        for (int w = 1; w < TF32_CONSUMERS / 32; ++w) m = fminf(m, rb[w * BN + c]);
        out[(size_t)(q0 + c) * ngroups + g] = m;
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
  }
}

// The tensor maps of both phases: the store's rows in boxes of a group, the
// queries' halves in boxes of bn.
bool flat_tf32_maps(CUtensorMap (&maps)[3], const void* x, const void* qhi, const void* qlo,
                    int nq, long long n, int d, int bn) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(qhi) |
                        reinterpret_cast<uintptr_t>(qlo)) % 16 == 0;
  return nq >= 1 && n >= 1 && n <= (long long)INT_MAX - TF32_GROUP && d >= 4 && d % 4 == 0 &&
         aligned && encoder() && tensor_map(&maps[0], x, d, n, d, TF32_GROUP, 1, n * d, 1) &&
         tensor_map(&maps[1], qhi, d, nq, d, bn, 1, (long long)nq * d, 1) &&
         tensor_map(&maps[2], qlo, d, nq, d, bn, 1, (long long)nq * d, 1);
}

template <int BN, bool RESCORE>
cudaError_t launch_flat_tf32(const CUtensorMap (&maps)[3], const void* norms, const void* cand,
                             void* out, int nq, long long n, int d, int gps, int t,
                             cudaStream_t stream) {
  const int ngroups = (int)((n + TF32_GROUP - 1) / TF32_GROUP);
  const int nqt = (nq + BN - 1) / BN;
  const long long grid =
      RESCORE ? (long long)nq * t : (long long)((ngroups + gps - 1) / gps) * nqt;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = flat_tf32_kernel<BN, RESCORE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tf32Layout<BN>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, TF32_THREADS, Tf32Layout<BN>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(norms), static_cast<const int*>(cand),
      static_cast<float*>(out), nq, n, d, ngroups, nqt, gps, t);
  return cudaGetLastError();
}

template <bool RESCORE>
int flat_tf32(const void* x, const void* qhi, const void* qlo, const void* norms,
              const void* cand, void* out, int nq, long long n, int d, int bn, int gps, int t,
              void* stream) {
  CUtensorMap maps[3];
  if ((RESCORE ? t : gps) < 1 || !flat_tf32_maps(maps, x, qhi, qlo, nq, n, d, bn))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch_flat_tf32<16, RESCORE>(maps, norms, cand, out, nq, n, d, gps, t, s);
    case 32: return launch_flat_tf32<32, RESCORE>(maps, norms, cand, out, nq, n, d, gps, t, s);
    case 64: return launch_flat_tf32<64, RESCORE>(maps, norms, cand, out, nq, n, d, gps, t, s);
    case 128: return launch_flat_tf32<128, RESCORE>(maps, norms, cand, out, nq, n, d, gps, t, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (n, d) f32 store; qhi, qlo: (nq, d) f32, the queries' tf32 halves as
// ops/kmeans.tf32_split makes them (hi = tf32(q), lo = tf32(q - hi), each
// rounded to nearest); norms (n,). bn: queries per tile (16, 32, 64 or
// 128), the same in both phases (ops/topk.py wgmma_plan). d must be a
// multiple of 4 and every pointer 16-byte aligned (the Tensor Memory
// Accelerator's rule). Each returns the cudaError_t of its launch (0 =
// success).

// Phase 1: out (nq, ngroups) f32 group mins; gps groups per block.
int ise_groupmin_tf32(const void* x, const void* qhi, const void* qlo, const void* norms,
                      void* out, int nq, long long n, int d, int bn, int gps, void* stream) {
  return flat_tf32<false>(x, qhi, qlo, norms, nullptr, out, nq, n, d, bn, gps, 0, stream);
}

// Phase 2: cand (nq, t) int32 group ids; out (nq, t * 128) f32 scores.
int ise_rescore_tf32(const void* x, const void* qhi, const void* qlo, const void* norms,
                     const void* cand, void* out, int nq, long long n, int d, int t, int bn,
                     void* stream) {
  return flat_tf32<true>(x, qhi, qlo, norms, cand, out, nq, n, d, bn, 1, t, stream);
}

}  // extern "C"
