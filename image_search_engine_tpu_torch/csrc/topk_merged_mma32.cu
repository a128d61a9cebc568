// The merged two-phase search's bf16 route (route 1 of topk_merged.cu, which
// describes the design) on query tiles of 32: the kernel's instantiations
// for this tile, in a source of their own so that the route's four tiles
// build in parallel.

#include <cuda_runtime.h>

#include "topk_merged.cuh"

cudaError_t ise_merged::launch_mma32(const MergedArgs& a, int vec, bool resident, int grid,
                                     int smem, cudaStream_t s) {
  return launch_mma_tile<32>(a, vec, resident, grid, smem, s);
}
