// The candidate select for Hopper (sm_90a), with a plain C interface for
// ctypes (ops/_kernels.py builds this file with nvcc and binds it; ops/topk.py
// holds the wrapper, its plan and the plain PyTorch version).
//
//   select_radix_kernel  per row of a contiguous f32 (Q, W) array, the t
//                        smallest entries in ascending (value, position)
//                        order, ties to the lowest position, for every
//                        t <= W. Replaces image_search_engine_tpu/ops/
//                        topk_pallas.py _select_topt_kernel. (The TPU
//                        kernel's t extract-min passes are ported as
//                        topk_twophase.cu select_kernel, which no search
//                        path launches: chip_smoke.py times it beside this.)
//
// Bound: the row is read once, Q * W * 4 bytes (128 MB at the bench point,
// 0.038 ms at 3.35 TB/s), and the output written once. The extract-min
// kernel makes t serial passes over the row, each with two block-wide
// reductions, so it is bound by the latency of those passes. This kernel
// reads the row once, into shared memory (rows of up to SEL_STAGE_MAX
// entries; wider ones are re-read through L1/L2), and finds the t-th
// smallest (key, position) pair by a radix select: 8-bit digits of an
// order-preserving 32-bit key, most significant first, one shared-memory
// histogram and three barriers per digit, starting below the bits that the
// entries' smallest and largest keys share. When the bin that holds the
// t-th entry holds exactly the entries still wanted, the select stops; when
// the key is resolved and the t-th key is tied, it goes on over the bits of
// the positions among the tied entries, so ties go to the lowest position.
// The entries at or below the found pair (exactly t of them) are compacted,
// and only those are sorted: up to SEL_MAX_T of them each by counting the
// pairs below it; up to SEL_BIG_T_MAX by a bitonic sort of their (key,
// position) pairs in shared memory, padded to a power of two (log t (log t +
// 1) / 2 barriers); beyond, compacted in position order into a global
// scratch and sorted there by a stable LSD radix sort over the key's four
// 8-bit digits (two barriers per 256 entries a digit). The number of
// barriers of the threshold is bounded by the digits of the key and the
// position, not by t.
//
// A digit pass costs a few dozen instructions an entry (the key, votes,
// shared-memory atomics), so for t up to SEL_MAX_T the passes run over few
// entries: first over a sample, every stride-th entry of the row, whose t-th
// pair is at or above the row's (a subset's t-th smallest is no smaller);
// one pass over the row compacts the entries at or below it, about stride *
// t of them; up to SEL_RANK_MAX of them are then ranked directly by
// counting, more go through the digit passes first. Should they overflow
// the scratch (rows whose smallest entries avoid the sampled positions), the
// select runs over the whole row, as it does for larger t.
//
// The key: the float's bits, sign-flipped so that unsigned order is float
// order, with -0.0 folded onto +0.0 (they compare equal, so they order by
// position, as the stable sort and the extract-min kernel order them) and
// every NaN onto one key above +inf; each output value keeps its own bits.
//
// Rows of a few queries are split over `split` blocks (ops/topk.py
// select_plan), so that more SMs read them: each block selects the t best
// of its slice into scratch, and the last block of the row to finish (a
// ticket counter per row, reset by that block) selects the t best of those
// candidates with their positions. The lexicographic key makes that merge
// exact.

// The algorithm's device code is in select_radix.cuh, shared with the merged
// search (topk_merged.cu), which runs it on rows written in the same launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "select_radix.cuh"

namespace {

// One block per slice of a row: select_radix_block (select_radix.cuh) with
// b = blockIdx.x, the block's own barrier and the read-only path.
template <bool kStaged>
__global__ void __launch_bounds__(SEL_THREADS)
    select_radix_kernel(const float* __restrict__ mins, float* __restrict__ vals,
                        int* __restrict__ ids, float* part_v, int* part_i,
                        unsigned* counters, uint64_t* sort_g, int w, int t, int split,
                        int slice) {
  __shared__ SelectShared s;
  extern __shared__ __align__(16) unsigned char dyn[];
  select_radix_block<kStaged, false, 0>(mins, vals, ids, part_v, part_i, counters, sort_g, w, t,
                                        split, slice, blockIdx.x, dyn, s);
}

}  // namespace

extern "C" {

// mins (nq, w) f32 -> vals (nq, t) f32, ids (nq, t) int32, 0 < t <= w, on
// the plan of ops/topk.py select_plan: split blocks per row of slice
// entries each (split * slice >= w, no empty slice), each staging its slice
// in shared memory when staged is 1 (slice <= SEL_STAGE_MAX); with split >
// 1, part_v / part_i hold nq * split * t entries and counters nq zeros
// (left zero); for t > SEL_BIG_T_MAX, sort_g holds nq * 2 * t 64-bit
// entries of scratch. Returns the cudaError_t of the launch (0 = success).
int ise_select_radix(const void* mins, void* vals, void* ids, void* part_v, void* part_i,
                     void* counters, void* sort_g, int nq, int w, int t, int split, int slice,
                     int staged, void* stream) {
  if (nq < 1 || t < 1 || t > w || split < 1 || slice < 1 ||
      (long long)split * slice < w || (long long)(split - 1) * slice >= w ||
      (staged != 0 && slice > SEL_STAGE_MAX))
    return cudaErrorInvalidValue;
  if (split > 1 && (slice < t || split * t > SEL_MERGE_MAX)) return cudaErrorInvalidValue;
  if (t > SEL_BIG_T_MAX && sort_g == nullptr) return cudaErrorInvalidValue;
  const long long grid = (long long)nq * split;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  staged = staged != 0 ? 1 : 0;
  // the staged slice, then the scratch, where the merge also stages its
  // split * t <= SEL_MERGE_MAX candidates, then the sort's
  const size_t smem =
      (staged ? (size_t)slice * sizeof(float) : 0) + SEL_CAND_BYTES + sort_bytes(t);
  auto kernel = staged ? select_radix_kernel<true> : select_radix_kernel<false>;
  // the shared-memory limit, raised once per device and instantiation
  static bool configured[SEL_MAX_DEVICES][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= SEL_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!configured[dev][staged]) {
    const size_t most = (staged ? (size_t)SEL_STAGE_MAX * sizeof(float) : 0) + SEL_CAND_BYTES +
                        sort_bytes(SEL_BIG_T_MAX);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    configured[dev][staged] = true;
  }
  kernel<<<(unsigned)grid, SEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mins), static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(part_v), static_cast<int*>(part_i), static_cast<unsigned*>(counters),
      static_cast<uint64_t*>(sort_g), w, t, split, slice);
  return cudaGetLastError();
}

}  // extern "C"
