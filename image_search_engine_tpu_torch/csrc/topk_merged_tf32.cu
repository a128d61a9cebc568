// The merged two-phase search's f32 route on Hopper's warpgroup MMA (route
// 2 of topk_merged.cu, which describes the design; 3xTF32, groupmin_tf32.cuh),
// in a source of its own so that it builds beside the other routes. Its
// blocks are 384 threads: the producer warpgroup streams a sweep or rescore
// item's stages into the ring, the two consumer warpgroups multiply them
// and run the select items, behind named barrier 2, in the ring's bytes.
// The select is inlined: a call would serialize the kernel's wgmmas.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_tf32.cuh"
#include "select_radix.cuh"
#include "topk_merged.cuh"

namespace {

// ---- route 2: f32 on the warpgroup MMA (3xTF32), BN queries per tile ----
template <int BN>
__device__ __forceinline__ Tf32Work tf32_item(const MergedArgs& a, const MergedItem& it) {
  if (it.kind == ITEM_SWEEP)
    return tf32_work<BN, false>((unsigned)it.index, a.nqt, a.gps, a.ngroups, a.t,
                                [](long long) { return 0; });
  const int g = it.g[0];
  return tf32_work<BN, true>((unsigned)it.index, a.nqt, a.gps, a.ngroups, a.t,
                             [g](long long) { return g; });
}

template <int BN>
__global__ void __launch_bounds__(TF32_THREADS, 1)
    merged_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap himap,
                       const __grid_constant__ CUtensorMap lomap, const MergedArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ MergedItem desc[2];
  const Tf32Smem<BN> m = tf32_smem<BN>(smem_raw);
  const int nkc = (a.d + SW128_COLS - 1) / SW128_COLS;
  if (threadIdx.x == 0) tf32_init_barriers(m.full, m.empty);
  __syncthreads();
  int base = 0;  // stages this block has passed through the ring

  if (threadIdx.x >= TF32_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    for (int k = 0;; ++k) {
      __syncthreads();
      const MergedItem it = desc[k & 1];
      if (it.kind == ITEM_DONE) return;
      if (it.kind == ITEM_SELECT) continue;
      const Tf32Work w = tf32_item<BN>(a, it);
      const int ntiles = (w.g1 - w.g0) * nkc;
      if (threadIdx.x == TF32_CONSUMERS)
        tf32_produce<BN>(m, &xmap, &himap, &lomap, w, nkc, ntiles, base);
      base += ntiles;
    }
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) desc[k & 1] = next_item<ROUTE_TF32>(a);
    __syncthreads();
    const MergedItem it = desc[k & 1];
    if (it.kind == ITEM_DONE) return;
    if (it.kind == ITEM_SELECT) {
      select_query<2>(a, it.index, m.smem);
      // the select wrote the ring's bytes: hand them back to the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      publish(a.counters + 1 + a.units + it.index, [] { consumer_barrier(); });
      continue;
    }
    const Tf32Work w = tf32_item<BN>(a, it);
    const int ntiles = (w.g1 - w.g0) * nkc;
    if (it.kind == ITEM_SWEEP) {
      tf32_consume<BN, false>(m, a.norms, a.mins, a.nq, a.n, a.ngroups, w, nkc, ntiles, base);
      publish(a.counters + 1 + it.unit, [] { consumer_barrier(); });
    } else {
      tf32_consume<BN, true>(m, a.norms, a.scores, a.nq, a.n, a.ngroups, w, nkc, ntiles, base);
    }
    base += ntiles;
  }
}

// ---- launch ----

template <int BN>
cudaError_t launch_tf32(const CUtensorMap (&maps)[3], const MergedArgs& a, int grid,
                        cudaStream_t s) {
  constexpr int smem = (int)Tf32Layout<BN>::SMEM;
  // the select works in the ring
  if (merged_select_smem(a.t) >
      (size_t)TF32_STAGES * Tf32Layout<BN>::STAGE)
    return cudaErrorInvalidValue;
  auto kernel = merged_tf32_kernel<BN>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TF32_THREADS, smem, s>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Route 2 of ise_topk_merged (topk_merged.cu), with its arguments: the f32
// store x, the queries' tf32 halves qhi and qlo (q unread), wgmma_plan's
// bq; d a multiple of 4 and every pointer 16-byte aligned. Returns the
// cudaError_t of the launch (0 = success).
int ise_topk_merged_tf32(int route, const void*, const void* qhi, const void* qlo,
                         const void* norms, const void* x, void* mins, void* cand, void* thr,
                         void* scores, void* vals, void* sort_g, void* counters, int nq,
                         long long n, int d, int t, int bq, int gps, int tpu, int dp, int kc,
                         int rkc, int, int, int grid, int smem, void* stream) {
  MergedArgs a;
  CUtensorMap maps[3];
  if (route != ROUTE_TF32 ||
      !merged_args(a, route, nullptr, norms, x, mins, cand, thr, scores, vals, sort_g, counters,
                   nq, n, d, t, bq, gps, tpu, dp, kc, rkc, grid, smem) ||
      !flat_tf32_maps(maps, x, qhi, qlo, nq, n, d, bq))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bq) {
    case 16: return launch_tf32<16>(maps, a, grid, s);
    case 32: return launch_tf32<32>(maps, a, grid, s);
    case 64: return launch_tf32<64>(maps, a, grid, s);
    case 128: return launch_tf32<128>(maps, a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
