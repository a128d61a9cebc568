// groupmin_chunked on Hopper's warpgroup MMA (sm_90a): the 128-row group
// mins, group-major (ngroups, Q), of a bf16 query against a bf16 store, from
// the TMA-fed bf16 wgmma sweep of groupmin_wgmma.cuh with the ChunkedMins
// output policy, on ops/groupmin_variants.py chunked_plan's tiles. Replaces
// benchmarks/sweep_chunked.py:53 chunked_kernel (launched :74). A plain C
// interface for ctypes: ops/_kernels.py builds this file, and
// ops/groupmin_variants.py holds the wrapper and its plain PyTorch version.
//
// The TPU kernel's question was whether the matrix unit's product of the
// next chunk of a tile's columns overlaps the vector unit's mins of this
// one. Here the product runs asynchronously on the tensor cores while the
// CUDA cores take mins: the sweep's two consumer warpgroups take the rows'
// products in turn (ping-pong), so one warpgroup's mins of a group overlap
// the other's product. A TPU chunk (512 or 1024 rows of one product before
// its mins) cannot be a warpgroup's product here: its f32 sums for 128
// queries would need 256-512 KB of registers, the SM's whole file or more.
// The rows between two epilogues of a warpgroup are one 128-row group, and
// `chunk` sets what it can: the rows the ring keeps in flight, as many
// stages as hold `chunk` rows where shared memory allows (chunked_plan).
//
// The CUDA-core kernel it replaced (groupmin_variants.cu, an 8-query x
// 16-row register tile of f32 FMAs a thread) is chip_smoke.py's comparison
// only.

#include <cuda_runtime.h>

#include "groupmin_wgmma.cuh"

extern "C" {

// A bf16 query (nq, d), f32 norms (n,), a bf16 store (n, d) and out
// (ceil(n / 128), nq) f32; d % 8 == 0 and q, x 16-byte aligned; bq, kc,
// stages, gps, resident and smem as chunked_plan gives them. Returns the
// launch's cudaError_t.
int ise_groupmin_chunked_wgmma(const void* q, const void* norms, const void* x, void* out, int nq,
                               long long n, int d, int bq, int kc, int stages, int gps,
                               int resident, int smem, void* stream) {
  return groupmin_wgmma<ChunkedMins>(q, norms, x, out, nq, n, d, bq, kc, stages, gps, resident,
                                     smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
