// IVF probed scan for Hopper (sm_90a), with a plain C interface for ctypes
// (ops/_kernels.py builds it; ops/ivf.py holds the wrapper and the plain
// PyTorch version).
//
//   probed_scan_kernel  for each (query, probe slot), the scores
//                       norms[b, r] - 2 q.x[b, r] of every row r of the
//                       probed bucket b, read in place from the
//                       list-contiguous (nbuckets, cap, d) table. Replaces
//                       image_search_engine_tpu/ops/ivf_pallas.py
//                       _probed_scan_kernel.
//
// Bound: the probed bytes (each probed bucket's cap * d * itemsize), read as
// contiguous (cap, d) blocks; at serving batch sizes the flops are far below
// the card's rate. The TPU kernel padded cap and d to 128; here the ragged
// edges are masked and nothing is copied. One probed bucket is split over
// ceil(cap / 32) blocks of 32 rows (4 per warp), so a single query with a
// handful of probes still puts tens of blocks per probe on the SMs, as the
// flat search's rescore splits a candidate group over 4 blocks. Rows are
// scored by the flat search's per-row routine (scoring.cuh). Pad slots carry
// +inf norms and finite rows, so they score +inf (never NaN); a negative
// bucket id scores +inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "scoring.cuh"

namespace {

constexpr int SCAN_ROWS = 32;  // rows of a bucket per block (4 per warp)

// Block b scores rows [s * SCAN_ROWS, min(cap, (s + 1) * SCAN_ROWS)) of
// probe slot b / nsplit (slot = query * nprobe + p, s = b % nsplit) into
// out[slot * cap + r].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    probed_scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
                       const float* __restrict__ norms, const int* __restrict__ probe,
                       float* __restrict__ out, int nprobe, int nbuckets, int cap, int d,
                       int nsplit) {
  extern __shared__ float qs[];  // d
  const long long slot = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int qi = (int)(slot / nprobe);
  stage_queries(q, qs, qi, 1, qi + 1, d);
  __syncthreads();

  const int b = __ldg(probe + slot);
  const bool live = b >= 0 && b < nbuckets;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_end = min(cap, (s + 1) * SCAN_ROWS);
  for (int r = s * SCAN_ROWS + warp; r < r_end; r += WARPS) {
    float score = INFINITY;
    if (live) {
      const long long row = (long long)b * cap + r;
      float acc[1];
      row_dot<T, VEC, 1>(x + row * d, qs, d, lane, acc);
      score = score_of(__ldg(norms + row), acc[0]);
    }
    if (lane == 0) out[slot * cap + r] = score;
  }
}

template <typename T, int VEC>
cudaError_t launch_probed_scan(const void* q, const void* x, const void* norms, const void* probe,
                               void* out, int nq, int nprobe, int nbuckets, int cap, int d,
                               cudaStream_t stream) {
  const int nsplit = (cap + SCAN_ROWS - 1) / SCAN_ROWS;
  const long long blocks = (long long)nq * nprobe * nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)d * sizeof(float);
  auto kernel = probed_scan_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(norms),
      static_cast<const int*>(probe), static_cast<float*>(out), nprobe, nbuckets, cap, d, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16 table (the query in the same type).
// vec: 1, or 16 bytes' worth of elements (4 for f32, 8 for bf16) when rows
// are 16-byte aligned. Returns the cudaError_t of the launch (0 = success).
int ise_probed_scan(int dtype, const void* q, const void* x, const void* norms, const void* probe,
                    void* out, int nq, int nprobe, int nbuckets, int cap, int d, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_probed_scan<float, 4>(q, x, norms, probe, out, nq, nprobe, nbuckets, cap, d, s);
  if (dtype == 0 && vec == 1)
    return launch_probed_scan<float, 1>(q, x, norms, probe, out, nq, nprobe, nbuckets, cap, d, s);
  if (dtype == 1 && vec == 8)
    return launch_probed_scan<__nv_bfloat16, 8>(q, x, norms, probe, out, nq, nprobe, nbuckets,
                                                cap, d, s);
  if (dtype == 1 && vec == 1)
    return launch_probed_scan<__nv_bfloat16, 1>(q, x, norms, probe, out, nq, nprobe, nbuckets,
                                                cap, d, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
