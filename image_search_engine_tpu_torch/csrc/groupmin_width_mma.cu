// groupmin_width on Hopper's tensor cores (sm_90a): the mins of G-row
// groups, G in {128, 64, 32}, group-major (ceil(N/G), Q), from production's
// bf16 group-min sweep (groupmin_mma.cuh) with the WidthMins<G> output
// policy, on ops/topk.py mma_plan's tiles. Replaces
// benchmarks/rescore_variants2.py:61 groupmin_kernel (launched :86). A plain
// C interface for ctypes: ops/_kernels.py builds this file, and
// ops/groupmin_variants.py holds the wrapper and its plain PyTorch version.
// groupmin_variants.cu says what bounds it. A file of its own lets nvcc
// build its 72 instantiations (3 widths x 4 query tiles x 3 copy widths x 2
// tile residencies) beside the other sources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "groupmin_mma.cuh"

extern "C" {

// A bf16 query (Q, d), f32 norms (N,), a bf16 store (N, d) and out (ceil(N /
// group), Q) f32; group 128, 64 or 32; bq, dp, kc, gps, resident, smem and
// vec as ise_groupmin_mma takes them. Returns the launch's cudaError_t.
int ise_groupmin_width_mma(const void* q, const void* norms, const void* x, void* out, int nq,
                           long long n, int d, int group, int bq, int dp, int kc, int gps,
                           int resident, int smem, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (group == 128)
    return groupmin_mma<bf16, WidthMins<128>>(q, nullptr, norms, nullptr, x, out, nq, n, d, bq,
                                              dp, kc, gps, resident, smem, vec, s);
  if (group == 64)
    return groupmin_mma<bf16, WidthMins<64>>(q, nullptr, norms, nullptr, x, out, nq, n, d, bq, dp,
                                             kc, gps, resident, smem, vec, s);
  if (group == 32)
    return groupmin_mma<bf16, WidthMins<32>>(q, nullptr, norms, nullptr, x, out, nq, n, d, bq, dp,
                                             kc, gps, resident, smem, vec, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
