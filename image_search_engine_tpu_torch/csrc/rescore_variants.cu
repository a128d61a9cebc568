// The phase-2 candidate rescore's prototype variants for Hopper (sm_90a), with
// a plain C interface for ctypes (ops/_kernels.py builds this file; ops/
// rescore_variants.py holds the wrappers and the plain PyTorch versions).
// Each takes a bf16 query (Q, d), a bf16 store (N, d) and per query t
// candidate 128-row groups cand (Q, t) int32, and scores every row of those
// groups, out (Q, t*128) f32 with column j*128 + r for row cand[:, j]*128 + r,
// as the production rescore kernel (topk_twophase.cu) lays it out:
//
//   rescore_gather_kernel  x.x - 2 q.x, the row's squared norm taken from the
//                          gathered bf16 row itself; rows at or past N score
//                          +inf. Replaces benchmarks/gather_kernel_proto.py:49
//                          rescore_kernel (launched :119) and
//                          benchmarks/gather_kernel_sweep2.py:40 rescore_kernel
//                          (launched :112), one body.
//   rescore_cross_kernel   the raw cross product q.x only (the caller adds the
//                          norms); rows at or past N write 0, what the TPU
//                          script's zero-padded store gives. Replaces
//                          benchmarks/rescore_dma_variants.py:33
//                          _cross_only_kernel (launched :109).
//
// What bounds them on the H100: the gathered bytes. At bench.py's point (N =
// 1M, d = 128, Q = 2048, t = 12) the 24,576 picks read 32 KB each, 805 MB;
// they fall on at most 7,813 distinct groups (the 256 MB store), so the least
// the card could move is the distinct groups' bytes plus the 12.6 MB of
// scores (<= 0.080 ms at 3.35 TB/s). The products (2 or 4 per element, 0.2-0.4
// GFLOP) are nothing beside it. The design reads each picked row once, in
// place from the store (no (Q, t*128, d) gather buffer, nothing padded or
// copied):
//   * one block per (query block of QB queries, candidate slot): the QB
//     (query, group) pairs of the TPU grid step, QB in {8, 16, 32};
//   * the block stages its QB query rows in shared memory, widened to f32
//     (exact; <= 32 x d x 4 bytes);
//   * each half-warp scores one row: at d = 128 a bf16 row is 256 bytes, 16
//     lanes x one 16-byte load, so a warp reads two neighbouring rows of one
//     group, 512 contiguous bytes, and no lane idles (the production kernel
//     gives a row a full warp, of which 16 lanes load at d = 128). Rows that
//     are not 16-byte multiples at 16-byte aligned addresses take scalar loads;
//   * q.x and, for the gather kernel, x.x accumulate in f32 FMAs over the
//     row's widened values, then a butterfly within the half-warp; the score
//     is x.x - 2 q.x rounded once.
// Its own row routine: scoring.cuh's row_dot (a warp per row) stays as it is,
// since the production certificate rests on phase 1 and phase 2 sharing it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "scoring.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GROUP = 128;            // candidate-group width (rows)
constexpr int HALF = 16;              // lanes that score one row
constexpr int ROWS_PER_STEP = 2 * WARPS;  // rows a block scores per step

// The dots of one bf16 row with one staged f32 query row, by the 16 lanes of
// a half-warp (hl = lane within it): qx = q.x and, with NORM, xx = x.x, each
// summed in f32. A lane with load = false contributes zeros; every lane of
// the warp must call this together (the butterfly is warp-wide).
template <int VEC, bool NORM>
__device__ __forceinline__ void half_row_dots(const bf16* __restrict__ row, const float* qrow,
                                              int d, int hl, bool load, float& qx, float& xx) {
  qx = 0.f;
  xx = 0.f;
  if (load) {
    const int nvec = d / VEC;
    for (int c = hl; c < nvec; c += HALF) {
      float xv[VEC];
      Loader<bf16, VEC>::load(row + (size_t)c * VEC, xv);
      const float* qp = qrow + (size_t)c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qx = fmaf(qp[e], xv[e], qx);
        if (NORM) xx = fmaf(xv[e], xv[e], xx);
      }
    }
  }
#pragma unroll
  for (int off = HALF / 2; off > 0; off >>= 1) {
    qx += __shfl_xor_sync(0xffffffffu, qx, off);
    if (NORM) xx += __shfl_xor_sync(0xffffffffu, xx, off);
  }
}

// Block b scores slot jt = b % t of queries [q0, q0 + QB), q0 = (b / t) * QB:
// pair p (query q0 + p, group cand[(q0 + p) * t + jt]) has rows u = p * 128 +
// r, and step s gives half-warp h (of 2 * WARPS) the row u = s * 16 + h, so a
// warp reads rows r and r + 1 of one group. Queries past nq are masked: their
// candidate id is not read and nothing is written.
template <int QB, int VEC, bool GATHER>
__global__ void __launch_bounds__(THREADS)
    rescore_variant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ x,
                           const int* __restrict__ cand, float* __restrict__ out, int nq,
                           long long n, int d, int t) {
  extern __shared__ float qs[];  // QB * d
  __shared__ int gid[QB];
  const int jt = (int)(blockIdx.x % (unsigned)t);
  const int q0 = (int)(blockIdx.x / (unsigned)t) * QB;
  stage_queries(q, qs, q0, QB, nq, d);
  if (threadIdx.x < QB) {
    const int qi = q0 + (int)threadIdx.x;
    gid[threadIdx.x] = qi < nq ? __ldg(cand + (size_t)qi * t + jt) : -1;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int hl = lane % HALF;
  for (int u = (int)threadIdx.x / HALF; u < QB * GROUP; u += ROWS_PER_STEP) {
    const int p = u / GROUP;
    const int r = u % GROUP;
    const int g = gid[p];
    const long long row = (long long)g * GROUP + r;
    const bool valid = g >= 0 && row < n;  // rows past N (and masked queries) are not loaded
    float qx, xx;
    half_row_dots<VEC, GATHER>(x + (valid ? row : 0LL) * d, qs + (size_t)p * d, d, hl, valid,
                               qx, xx);
    if (hl == 0 && q0 + p < nq) {
      float v;
      if (GATHER) {
        v = valid ? score_of(xx, qx) : INFINITY;
      } else {
        v = valid ? qx : 0.f;
      }
      out[((size_t)(q0 + p) * t + jt) * GROUP + r] = v;
    }
  }
}

template <int QB, int VEC, bool GATHER>
cudaError_t launch_variant(const void* q, const void* x, const void* cand, void* out, int nq,
                           long long n, int d, int t, cudaStream_t stream) {
  const long long blocks = (long long)((nq + QB - 1) / QB) * t;
  if (t <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)QB * d * sizeof(float);
  auto kernel = rescore_variant_kernel<QB, VEC, GATHER>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(x), static_cast<const int*>(cand),
      static_cast<float*>(out), nq, n, d, t);
  return cudaGetLastError();
}

template <bool GATHER, int VEC>
cudaError_t variant_qb(const void* q, const void* x, const void* cand, void* out, int nq,
                       long long n, int d, int t, int qb, cudaStream_t s) {
  switch (qb) {
    case 8: return launch_variant<8, VEC, GATHER>(q, x, cand, out, nq, n, d, t, s);
    case 16: return launch_variant<16, VEC, GATHER>(q, x, cand, out, nq, n, d, t, s);
    case 32: return launch_variant<32, VEC, GATHER>(q, x, cand, out, nq, n, d, t, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool GATHER>
cudaError_t launch_kind(const void* q, const void* x, const void* cand, void* out, int nq,
                    long long n, int d, int t, int qb, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) return variant_qb<GATHER, 8>(q, x, cand, out, nq, n, d, t, qb, s);
  if (vec == 1) return variant_qb<GATHER, 1>(q, x, cand, out, nq, n, d, t, qb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Both take a bf16 query (Q, d), a bf16 store (N, d), cand (Q, t) int32 and
// out (Q, t*128) f32, and return the cudaError_t of the launch (0 = success).
// qb: queries per block (8, 16 or 32); vec: 8 when store rows are 16-byte
// multiples at 16-byte aligned addresses, else 1.

int ise_rescore_gather(const void* q, const void* x, const void* cand, void* out, int nq,
                       long long n, int d, int t, int qb, int vec, void* stream) {
  return launch_kind<true>(q, x, cand, out, nq, n, d, t, qb, vec, stream);
}

int ise_rescore_cross(const void* q, const void* x, const void* cand, void* out, int nq,
                      long long n, int d, int t, int qb, int vec, void* stream) {
  return launch_kind<false>(q, x, cand, out, nq, n, d, t, qb, vec, stream);
}

}  // extern "C"
