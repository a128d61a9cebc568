// Merged two-phase exact top-k for Hopper (sm_90a): the group-min sweep, the
// select and the candidate rescore of the two-phase search in ONE persistent
// launch, with a plain C interface for ctypes (ops/_kernels.py builds this
// file with nvcc and binds it; ops/topk_merged.py holds the wrapper,
// merged_candidates, its plan, merged_plan, the plain PyTorch version and
// the search, topk_merged).
//
// Replaces image_search_engine_tpu/ops/topk_merged.py _merged_kernel (via
// topk_merged). The TPU kernel is one program so that query block b's
// candidate copies and rescore run under block b+1's sweep, which separate
// programs cannot do on a TPU core. Here one launch runs the two-phase
// search's own routines on the route ops/topk.py _on_tensor_cores picks for
// both of its phases:
//
//   route 0, f32 on CUDA cores (up to F32_CUDA_CORE_MAX_Q queries, or rows
//     of no whole 16-byte units): twophase.cuh groupmin_block and
//     rescore_block (row_dot);
//   route 1, bf16 on tensor cores: groupmin_mma.cuh groupmin_mma_block
//     (mma.sync, QueryMajorMins) on ops/topk.py mma_plan's tile, and
//     twophase.cuh rescore_mma_block, two (query, group) pairs a block,
//     four warps each;
//   route 2, f32 beyond those queries over rows of whole 16-byte units:
//     groupmin_tf32.cuh's warpgroup 3xTF32 sweep and rescore on wgmma_plan's
//     query tile, a producer warpgroup and two consumer warpgroups;
//
// and on every route the select is select_radix.cuh's radix select
// (select_radix_block, one block a query). Each item runs the same code on
// the same operands as the kernel it comes from, so the mins, candidates,
// threshold and scores equal topk_twophase's bit for bit. This source holds
// the entry point and route 0; route 1 is topk_merged_mma<bq>.cu, one
// source per query tile, route 2 topk_merged_tf32.cu, so that they build in
// parallel; topk_merged.cuh is the scheduler they share.
//
// Schedule. The grid is persistent: ops/topk_merged.py merged_plan sizes it
// to the blocks that fit the card at once. A block takes work items from a
// global ticket (atomicAdd) in one fixed order over units, a unit being
// tiles_per_unit query tiles that sweep the store together, slice-major as
// the sweep kernels order their blocks (a unit's tiles share each slice in
// L2): the sweep of unit 0, the sweep of unit 1, the select of unit 0, the
// rescore of unit 0, the sweep of unit 2, the select of unit 1, ... So unit
// u's select and rescore start under the tail of unit u+1's sweep, and no
// block idles between the phases that three kernels would separate. A
// select item waits (an acquire load, spinning) until its unit's count of
// finished sweep items is whole; a rescore item until its query's select
// flag is set. A producer
// publishes with __threadfence() and then an atomicAdd. An item waits only
// on items dispensed before it, which blocks that are running hold, so the
// launch cannot deadlock, whatever the number of resident blocks. Mins and
// candidates written in this launch are read through L2 (__ldcg, or an
// acquire), never through the read-only path (__ldg) the kernels use on
// another launch's outputs: so the select reads its row from L2 and the
// rescore takes its group id from the block's scheduler, which read it
// after the wait. The counters are zeroed by the wrapper with the outputs.
//
// One block shape a route: 256 threads on routes 0 and 1 (the sweep's 8
// warps, the select's SEL_THREADS; route 1's rescore runs a pair on each
// half, behind named barriers 1 and 2), 384 on route 2 (the select on the
// two consumer warpgroups behind named barrier 2; the ring's mbarrier
// phases carry over from item to item). The shared memory of a block is the
// most any of its items needs: they run one at a time and reuse it (route
// 2's select in the ring, handed back to the Tensor Memory Accelerator with
// a proxy fence).
//
// What bounds it: what bounds the two-phase search, one read of the store
// per unit (bytes at serving batch sizes, the sweep's operations at large
// Q), then the candidate rows. Units cost a store pass each; what they buy
// is the select and rescore of unit u under the sweep of unit u+1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "scoring.cuh"
#include "topk_merged.cuh"
#include "twophase.cuh"

namespace {

// ---- route 0: f32 on CUDA cores, QT queries per sweep item ----
template <int VEC, int QT>
__global__ void __launch_bounds__(THREADS, 4) merged_cuda_kernel(const MergedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ MergedItem desc[2];
  const float* q = static_cast<const float*>(a.q);
  const float* x = static_cast<const float*>(a.x);
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) desc[k & 1] = next_item<ROUTE_CUDA>(a);
    __syncthreads();
    const MergedItem it = desc[k & 1];
    if (it.kind == ITEM_DONE) return;
    if (it.kind == ITEM_SWEEP) {
      groupmin_block<float, VEC, QT>(q, a.norms, x, a.mins, a.nq, a.n, a.d, a.ngroups, a.nqt,
                                     (unsigned)it.index);
      publish(a.counters + 1 + it.unit, [] { __syncthreads(); });
    } else if (it.kind == ITEM_SELECT) {
      select_query<0>(a, it.index, smem);
      publish(a.counters + 1 + a.units + it.index, [] { __syncthreads(); });
    } else {
      const int g = it.g[0];
      rescore_block<float, VEC>(q, a.norms, x, a.scores, a.n, a.d, a.t, (unsigned)it.index,
                                [g](long long) { return g; });
    }
  }
}

// ---- launch ----

template <int VEC>
cudaError_t launch_cuda(const MergedArgs& a, int grid, int smem, cudaStream_t s) {
  const void* fn = nullptr;
  switch (a.bq) {
    case 1: fn = (const void*)merged_cuda_kernel<VEC, 1>; break;
    case 2: fn = (const void*)merged_cuda_kernel<VEC, 2>; break;
    case 4: fn = (const void*)merged_cuda_kernel<VEC, 4>; break;
    case 8: fn = (const void*)merged_cuda_kernel<VEC, 8>; break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<MergedArgs*>(&a)};
  return cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args, smem, s);
}

}  // namespace

extern "C" {

// One launch of the merged search on the plan of ops/topk_merged.py
// merged_plan. route: 0 f32 on CUDA cores (bq: queries per sweep item, 1,
// 2, 4 or 8; vec 4 or 1), 1 bf16 on tensor cores (mma_plan's bq, dp, kc,
// resident; rkc the rescore's k-chunk; vec 8, 2 or 1); route 2, f32 on the
// warpgroup MMA, is ise_topk_merged_tf32 (topk_merged_tf32.cu), with the
// same arguments (qhi, qlo the queries' tf32 halves, read by it alone). q:
// the queries in the store dtype; norms (n,); mins (nq, ngroups), cand (nq,
// t) int32, thr (nq,), scores (nq, t * 128): the outputs; vals (nq, t) f32
// scratch; sort_g (nq, 2t) 64-bit scratch when t > 4096; counters 1 + units
// + nq zeroed int32 (units = ceil(nqt / tpu)). gps groups per sweep item (1
// on route 0), tpu query tiles per unit. grid blocks of smem dynamic shared
// memory. Returns the cudaError_t of the launch (0 = success).
int ise_topk_merged(int route, const void* q, const void*, const void*, const void* norms,
                    const void* x, void* mins, void* cand, void* thr, void* scores, void* vals,
                    void* sort_g, void* counters, int nq, long long n, int d, int t, int bq,
                    int gps, int tpu, int dp, int kc, int rkc, int resident, int vec, int grid,
                    int smem, void* stream) {
  MergedArgs a;
  if (!merged_args(a, route, q, norms, x, mins, cand, thr, scores, vals, sort_g, counters, nq, n,
                   d, t, bq, gps, tpu, dp, kc, rkc, grid, smem))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_CUDA) {
    if (gps != 1 || (size_t)smem < (size_t)bq * d * sizeof(float))
      return cudaErrorInvalidValue;
    if (vec == 4) return launch_cuda<4>(a, grid, smem, s);
    if (vec == 1) return launch_cuda<1>(a, grid, smem, s);
    return cudaErrorInvalidValue;
  }
  if (route == ROUTE_MMA) {
    constexpr int KSTEP = MMA_KBYTES / 2;
    const size_t need = groupmin_mma_smem(bq, nq, dp, kc, resident != 0, 2);
    if (!mma_plan_ok(d, dp, kc, KSTEP, (size_t)smem, need) || rkc < KSTEP || rkc % KSTEP != 0 ||
        (size_t)smem < 2 * round16(rescore_mma_smem(dp, rkc)))
      return cudaErrorInvalidValue;
    switch (bq) {
      case 16: return ise_merged::launch_mma16(a, vec, resident != 0, grid, smem, s);
      case 32: return ise_merged::launch_mma32(a, vec, resident != 0, grid, smem, s);
      case 64: return ise_merged::launch_mma64(a, vec, resident != 0, grid, smem, s);
      case 128: return ise_merged::launch_mma128(a, vec, resident != 0, grid, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
