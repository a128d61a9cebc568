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

// The routines are in groupmin_tf32.cuh, shared with the merged search
// (topk_merged.cu).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_tf32.cuh"

namespace {

// RESCORE false: phase 1, out (nq, ngroups) of mins, cand unread. RESCORE
// true: phase 2, out (nq * t, 128) of scores for the groups cand (nq, t);
// ngroups, nqt and gps unread. Block b is work item b (tf32_work).
template <int BN, bool RESCORE>
__global__ void __launch_bounds__(TF32_THREADS, 1)
    flat_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap himap,
                     const __grid_constant__ CUtensorMap lomap, const float* __restrict__ norms,
                     const int* __restrict__ cand, float* __restrict__ out, int nq, long long n,
                     int d, int ngroups, int nqt, int gps, int t) {
  extern __shared__ unsigned char smem_raw[];
  const Tf32Smem<BN> m = tf32_smem<BN>(smem_raw);
  const Tf32Work w = tf32_work<BN, RESCORE>(blockIdx.x, nqt, gps, ngroups, t,
                                            [cand](long long slot) { return __ldg(cand + slot); });
  const int nkc = (d + SW128_COLS - 1) / SW128_COLS;
  const int ntiles = (w.g1 - w.g0) * nkc;
  if (threadIdx.x == 0) tf32_init_barriers(m.full, m.empty);
  __syncthreads();  // the last block-wide barrier

  if (threadIdx.x >= TF32_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == TF32_CONSUMERS)
      tf32_produce<BN>(m, &xmap, &himap, &lomap, w, nkc, ntiles, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  tf32_consume<BN, RESCORE>(m, norms, out, nq, n, ngroups, w, nkc, ntiles, 0);
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
