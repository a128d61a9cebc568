// groupmin_two_level on Hopper's tensor cores (sm_90a): the 128-row group
// mins, group-major (ngroups, Q), and the 32-row subgroup mins rounded to
// bf16 in the layouts v1, v2 and v3, from production's bf16 group-min sweep
// (groupmin_mma.cuh) with the TwoLevelMins<L> output policy, on ops/topk.py
// mma_plan's tiles. Replaces benchmarks/subgroup_proto.py:39
// _kernel_two_level (launched :77) and benchmarks/subgroup_variants.py:36
// _kernel (launched :85). A plain C interface for ctypes: ops/_kernels.py
// builds this file, and ops/groupmin_variants.py holds the wrapper and its
// plain PyTorch version. groupmin_variants.cu says what bounds it. A file of
// its own lets nvcc build its 72 instantiations (3 layouts x 4 query tiles
// x 3 copy widths x 2 tile residencies) beside the other sources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "groupmin_mma.cuh"

extern "C" {

// A bf16 query (Q, d), f32 norms (N,), a bf16 store (N, d), gmin (ngroups,
// Q) f32 and smin bf16: (Q, nsub) for layout 0 (v1) and 1 (v2), (nsub, Q)
// for 2 (v3); bq, dp, kc, gps, resident, smem (v2's staging included) and
// vec as ise_groupmin_mma takes them. Returns the launch's cudaError_t.
int ise_groupmin_two_level_mma(const void* q, const void* norms, const void* x, void* gmin,
                               void* smin, int nq, long long n, int d, int layout, int bq, int dp,
                               int kc, int gps, int resident, int smem, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (layout == 0)
    return groupmin_mma<bf16, TwoLevelMins<0>>(q, nullptr, norms, nullptr, x, gmin, nq, n, d, bq,
                                               dp, kc, gps, resident, smem, vec, s, smin);
  if (layout == 1)
    return groupmin_mma<bf16, TwoLevelMins<1>>(q, nullptr, norms, nullptr, x, gmin, nq, n, d, bq,
                                               dp, kc, gps, resident, smem, vec, s, smin);
  if (layout == 2)
    return groupmin_mma<bf16, TwoLevelMins<2>>(q, nullptr, norms, nullptr, x, gmin, nq, n, d, bq,
                                               dp, kc, gps, resident, smem, vec, s, smin);
  return cudaErrorInvalidValue;
}

}  // extern "C"
