// The phase-1 group-min sweep's prototype variants for Hopper (sm_90a), with a
// plain C interface for ctypes (ops/_kernels.py builds this file; ops/
// groupmin_variants.py holds the wrappers and the plain PyTorch versions).
// Each scores norms[r] - 2 q.x[r] for a bf16 query against a bf16 store (f32
// sums, f32 norms) and keeps per-group minima, as the production groupmin
// kernel does, in the layouts the TPU prototypes tried:
//
//   groupmin_width        the mins of G-row groups, G in {128, 64, 32},
//                         group-major (ceil(N/G), Q). Replaces
//                         benchmarks/rescore_variants2.py:61 groupmin_kernel
//                         (launched :86). groupmin_width_mma.cu.
//   groupmin_two_level    one sweep, two outputs: the f32 mins of the 128-row
//                         groups, group-major (ngroups, Q), and the mins of
//                         the 32-row subgroups rounded to bf16, in one of
//                         three layouts (v1 query-major as each group ends,
//                         v2 query-major staged in shared memory for runs of
//                         8 groups, v3 subgroup-major). Replaces
//                         benchmarks/subgroup_proto.py:39 _kernel_two_level
//                         (launched :77) and benchmarks/subgroup_variants.py:36
//                         _kernel (launched :85). groupmin_two_level_mma.cu.
//   groupmin_chunked      the 128-row group mins, group-major, with each
//                         4096-row tile's product done C rows at a time (C in
//                         {512, 1024}): a (query tile x chunk) score tile in
//                         shared memory from register-blocked f32 FMAs, then a
//                         min pass over its groups, then the next chunk.
//                         Replaces benchmarks/sweep_chunked.py:53
//                         chunked_kernel (launched :74). This file.
//
// What bounds them on the H100: at the prototypes' point (N = 1M, d = 128, Q =
// 2048) the 2*Q*N*d = 5.2e11 operations (0.53 ms at the bf16 tensor-core
// peak, 7.8 ms at the f32 CUDA-core peak); the store (256 MB) and the mins
// written (32-256 MB) are a fraction of that. The width and two-level
// kernels are the production bf16 sweep itself (groupmin_mma.cuh: mma.sync
// m16n8k16 over a query tile in shared memory, the store streamed by
// double-buffered cp.async on ops/topk.py mma_plan's tiles) with another
// output policy (WidthMins<G>, TwoLevelMins<L>), so they cost what it costs
// plus their writes, and a 128-row min of either is bit for bit production
// groupmin's. Each has its own file so that nvcc builds their 72 kernels
// each beside the other sources, not after them.
//
// This file keeps the CUDA-core kernels they replaced, as chip_smoke.py's
// comparison only (ops/groupmin_variants.py routes to them when ROUTE says
// so): groupmin_width_kernel and groupmin_two_level_kernel keep the design
// production ran for bf16 before its tensor cores (one warp per row, row_dot
// from scoring.cuh, up to 8 queries staged per block), so their 128-row mins
// equal each other's bit for bit and the tensor cores' within f32 rounding.
// The chunked kernel is a register-blocked CUDA-core product whose sums run
// in another order (the same function within a few ulps).
//
// Rows at or past n score +inf (never padded or copied); groups or subgroups
// with no row below n are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "scoring.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// GROUP (128), SUB (32) and SUBS: groupmin_mma.cuh's, shared by every kernel here
constexpr int TWO_LEVEL_GROUPS = 8;  // groups per two-level block: 32 subgroups
constexpr int TILE_N = 4096;         // rows per chunked block (the TPU tile)
constexpr int KS = 8;                // depth of one staged slice (one 16-byte load)

// ---- row 10: G-row group mins on CUDA cores (chip_smoke.py's comparison) ----
//
// Block b handles query tile b % nqt (QT queries) of group b / nqt, so the
// nqt blocks that read one group run back to back and share it in L2.
// out[g * nq + q].
template <int G, int VEC, int QT>
__global__ void __launch_bounds__(THREADS)
    groupmin_width_kernel(const bf16* __restrict__ q, const float* __restrict__ norms,
                          const bf16* __restrict__ x, float* __restrict__ out, int nq, long long n,
                          int d, int nqt) {
  extern __shared__ float qs[];  // QT * d
  __shared__ float red[WARPS][QT];
  const int qt = blockIdx.x % nqt;
  const long long g = blockIdx.x / nqt;
  const int q0 = qt * QT;
  stage_queries(q, qs, q0, QT, nq, d);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float best[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) best[qi] = INFINITY;
  for (int r = warp; r < G; r += WARPS) {
    const long long row = g * G + r;
    if (row >= n) break;  // ragged last group: missing rows count as +inf
    float acc[QT];
    row_dot<bf16, VEC, QT>(x + row * d, qs, d, lane, acc);
    const float nr = __ldg(norms + row);
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) best[qi] = fminf(best[qi], score_of(nr, acc[qi]));
  }
  if (lane == 0) {
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) red[warp][qi] = best[qi];
  }
  __syncthreads();
  if (threadIdx.x < QT && q0 + (int)threadIdx.x < nq) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][threadIdx.x]);
    out[g * nq + q0 + threadIdx.x] = m;
  }
}

// ---- rows 12 and 13: group and subgroup mins on CUDA cores (chip_smoke.py's comparison) ----
//
// Block b handles query tile b % nqt of the run of TWO_LEVEL_GROUPS groups b
// / nqt. In each group warp w scores rows w + WARPS*j, j < 16, so row j's
// subgroup is j / 4: each warp keeps 4 subgroup mins per query in registers,
// and the block reduces them over its warps. A group min is the min of its
// subgroup mins, bit for bit the production kernel's group min.
// gmin[g * nq + q]; smin: LAYOUT 0 (v1) and 1 (v2) smin[q * nsub + s], LAYOUT
// 2 (v3) smin[s * nq + q].
template <int VEC, int QT, int LAYOUT>
__global__ void __launch_bounds__(THREADS)
    groupmin_two_level_kernel(const bf16* __restrict__ q, const float* __restrict__ norms,
                              const bf16* __restrict__ x, float* __restrict__ gmin,
                              bf16* __restrict__ smin, int nq, long long n, int d,
                              long long ngroups, long long nsub, int nqt) {
  constexpr int RUN_SUBS = TWO_LEVEL_GROUPS * SUBS;
  extern __shared__ float qs[];  // QT * d
  __shared__ float red[WARPS][QT][SUBS];
  __shared__ float tile[QT][RUN_SUBS];  // the run's subgroup mins (v2)
  const int qt = blockIdx.x % nqt;
  const long long run = blockIdx.x / nqt;
  const int q0 = qt * QT;
  stage_queries(q, qs, q0, QT, nq, d);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int gl = 0; gl < TWO_LEVEL_GROUPS; ++gl) {
    const long long g = run * TWO_LEVEL_GROUPS + gl;
    if (g >= ngroups) break;
    float best[QT][SUBS];
#pragma unroll
    for (int s = 0; s < SUBS; ++s) {
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) best[qi][s] = INFINITY;
      for (int j = 0; j < SUB / WARPS; ++j) {
        const long long row = g * GROUP + warp + WARPS * (s * (SUB / WARPS) + j);
        if (row >= n) break;  // ragged last group: missing rows count as +inf
        float acc[QT];
        row_dot<bf16, VEC, QT>(x + row * d, qs, d, lane, acc);
        const float nr = __ldg(norms + row);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) best[qi][s] = fminf(best[qi][s], score_of(nr, acc[qi]));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
        for (int s = 0; s < SUBS; ++s) red[warp][qi][s] = best[qi][s];
      }
    }
    __syncthreads();
    if (threadIdx.x < QT * SUBS) {
      // v3 puts consecutive threads on consecutive queries of one subgroup
      const int qi = LAYOUT == 2 ? threadIdx.x % QT : threadIdx.x / SUBS;
      const int s = LAYOUT == 2 ? threadIdx.x / QT : threadIdx.x % SUBS;
      float m = red[0][qi][s];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][qi][s]);
      tile[qi][gl * SUBS + s] = m;
      const long long sub = g * SUBS + s;
      if (q0 + qi < nq && sub < nsub) {
        if (LAYOUT == 0) smin[(size_t)(q0 + qi) * nsub + sub] = __float2bfloat16_rn(m);
        if (LAYOUT == 2) smin[(size_t)sub * nq + q0 + qi] = __float2bfloat16_rn(m);
      }
    }
    __syncthreads();
    if (threadIdx.x < QT && q0 + (int)threadIdx.x < nq) {
      float m = tile[threadIdx.x][gl * SUBS];
#pragma unroll
      for (int s = 1; s < SUBS; ++s) m = fminf(m, tile[threadIdx.x][gl * SUBS + s]);
      gmin[(size_t)g * nq + q0 + threadIdx.x] = m;
    }
  }
  if (LAYOUT == 1) {  // v2: each query's run of subgroups, consecutive threads on consecutive ones
    __syncthreads();
    for (int i = threadIdx.x; i < QT * RUN_SUBS; i += THREADS) {
      const int qi = i / RUN_SUBS;
      const int sl = i % RUN_SUBS;
      const long long sub = run * RUN_SUBS + sl;
      if (q0 + qi < nq && sub < nsub)
        smin[(size_t)(q0 + qi) * nsub + sub] = __float2bfloat16_rn(tile[qi][sl]);
    }
  }
}

// ---- row 11: chunked columns ----
//
// Block b handles query tile b % nqt (TQ = 2048 / C queries) of the
// TILE_N-row tile b / nqt, C rows at a time. Thread t owns an 8-query x
// 16-row register tile: queries (t / NT_R)*8 + i, rows t % NT_R + NT_R*j
// (NT_R = C / 16 threads across the chunk, so a warp reads consecutive rows
// of the staged slice and one broadcast query run). The product runs over d
// in slices of KS columns staged in shared memory as f32 (one 16-byte load
// per row or query and slice); the scores go to a (TQ, C) tile in shared
// memory; then each warp takes (query, group) pairs of the chunk and reduces
// each group's 128 scores with shuffles. out[g * nq + q].
template <int C>
__global__ void __launch_bounds__(THREADS)
    groupmin_chunked_kernel(const bf16* __restrict__ q, const float* __restrict__ norms,
                            const bf16* __restrict__ x, float* __restrict__ out, int nq,
                            long long n, int d, long long ngroups, int nqt) {
  constexpr int MQ = 8, MR = 16;
  constexpr int NT_R = C / MR;
  constexpr int NT_Q = THREADS / NT_R;
  constexpr int TQ = NT_Q * MQ;
  static_assert(NT_R % 32 == 0 && TQ * C == THREADS * MQ * MR, "tile shape");
  extern __shared__ float chunk_smem[];  // not smem: groupmin_mma.cuh declares that as bytes
  float* qs = chunk_smem;                // [KS][TQ]
  float* xs = qs + KS * TQ;              // [KS][C]
  float* sc = xs + KS * C;               // [TQ][C]
  const int qt = blockIdx.x % nqt;
  const long long tile0 = (blockIdx.x / nqt) * (long long)TILE_N;
  const int q0 = qt * TQ;
  const int tr = threadIdx.x % NT_R;
  const int tq = threadIdx.x / NT_R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int c0 = 0; c0 < TILE_N; c0 += C) {
    const long long r0 = tile0 + c0;
    if (r0 >= n) break;
    float acc[MQ][MR];
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
#pragma unroll
      for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += KS) {
      __syncthreads();  // the previous slice (or chunk's min pass) is done with smem
      for (int i = threadIdx.x; i < TQ + C; i += THREADS) {
        const bool is_q = i < TQ;
        const long long r = is_q ? (long long)q0 + i : r0 + (i - TQ);
        const bool ok = is_q ? r < nq : r < n;
        float v[KS];
        if (ok) {
          Loader<bf16, KS>::load((is_q ? q : x) + r * d + k0, v);
        } else {
#pragma unroll
          for (int e = 0; e < KS; ++e) v[e] = 0.f;
        }
        float* dst = is_q ? qs + i : xs + (i - TQ);
        const int stride = is_q ? TQ : C;
#pragma unroll
        for (int e = 0; e < KS; ++e) dst[e * stride] = v[e];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float a[MQ], b[MR];
#pragma unroll
        for (int i = 0; i < MQ; ++i) a[i] = qs[kk * TQ + tq * MQ + i];
#pragma unroll
        for (int j = 0; j < MR; ++j) b[j] = xs[kk * C + tr + NT_R * j];
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
#pragma unroll
          for (int j = 0; j < MR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const long long row = r0 + tr + NT_R * j;
      const float nr = row < n ? __ldg(norms + row) : 0.f;
#pragma unroll
      for (int i = 0; i < MQ; ++i)
        sc[(tq * MQ + i) * C + tr + NT_R * j] = row < n ? score_of(nr, acc[i][j]) : INFINITY;
    }
    __syncthreads();
    for (int p = warp; p < TQ * (C / GROUP); p += WARPS) {
      const int qi = p / (C / GROUP);
      const int gl = p % (C / GROUP);
      const float* sp = sc + qi * C + gl * GROUP;
      float m = sp[lane];
#pragma unroll
      for (int e = 1; e < GROUP / 32; ++e) m = fminf(m, sp[lane + 32 * e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const long long g = (r0 + gl * GROUP) / GROUP;
      if (lane == 0 && g < ngroups && q0 + qi < nq) out[g * nq + q0 + qi] = m;
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int G, int VEC, int QT>
cudaError_t launch_width(const void* q, const void* norms, const void* x, void* out, int nq,
                         long long n, int d, cudaStream_t stream) {
  const long long ngroups = (n + G - 1) / G;
  const int nqt = (nq + QT - 1) / QT;
  const size_t smem = (size_t)QT * d * sizeof(float);
  auto kernel = groupmin_width_kernel<G, VEC, QT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(ngroups * nqt), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(norms), static_cast<const bf16*>(x),
      static_cast<float*>(out), nq, n, d, nqt);
  return cudaGetLastError();
}

template <int G, int VEC>
cudaError_t width_qt(const void* q, const void* norms, const void* x, void* out, int nq,
                     long long n, int d, int qt, cudaStream_t s) {
  switch (qt) {
    case 1: return launch_width<G, VEC, 1>(q, norms, x, out, nq, n, d, s);
    case 2: return launch_width<G, VEC, 2>(q, norms, x, out, nq, n, d, s);
    case 4: return launch_width<G, VEC, 4>(q, norms, x, out, nq, n, d, s);
    case 8: return launch_width<G, VEC, 8>(q, norms, x, out, nq, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t width_vec(const void* q, const void* norms, const void* x, void* out, int nq,
                      long long n, int d, int qt, int vec, cudaStream_t s) {
  if (vec == 8) return width_qt<G, 8>(q, norms, x, out, nq, n, d, qt, s);
  if (vec == 1) return width_qt<G, 1>(q, norms, x, out, nq, n, d, qt, s);
  return cudaErrorInvalidValue;
}

template <int VEC, int QT, int LAYOUT>
cudaError_t launch_two_level(const void* q, const void* norms, const void* x, void* gmin,
                             void* smin, int nq, long long n, int d, cudaStream_t stream) {
  const long long ngroups = (n + GROUP - 1) / GROUP;
  const long long nsub = (n + SUB - 1) / SUB;
  const long long nruns = (ngroups + TWO_LEVEL_GROUPS - 1) / TWO_LEVEL_GROUPS;
  const int nqt = (nq + QT - 1) / QT;
  const size_t smem = (size_t)QT * d * sizeof(float);
  auto kernel = groupmin_two_level_kernel<VEC, QT, LAYOUT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(nruns * nqt), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(norms), static_cast<const bf16*>(x),
      static_cast<float*>(gmin), static_cast<bf16*>(smin), nq, n, d, ngroups, nsub, nqt);
  return cudaGetLastError();
}

template <int VEC, int QT>
cudaError_t two_level_layout(const void* q, const void* norms, const void* x, void* gmin,
                             void* smin, int nq, long long n, int d, int layout,
                             cudaStream_t s) {
  switch (layout) {
    case 0: return launch_two_level<VEC, QT, 0>(q, norms, x, gmin, smin, nq, n, d, s);
    case 1: return launch_two_level<VEC, QT, 1>(q, norms, x, gmin, smin, nq, n, d, s);
    case 2: return launch_two_level<VEC, QT, 2>(q, norms, x, gmin, smin, nq, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int VEC>
cudaError_t two_level_qt(const void* q, const void* norms, const void* x, void* gmin, void* smin,
                         int nq, long long n, int d, int layout, int qt, cudaStream_t s) {
  switch (qt) {
    case 1: return two_level_layout<VEC, 1>(q, norms, x, gmin, smin, nq, n, d, layout, s);
    case 2: return two_level_layout<VEC, 2>(q, norms, x, gmin, smin, nq, n, d, layout, s);
    case 4: return two_level_layout<VEC, 4>(q, norms, x, gmin, smin, nq, n, d, layout, s);
    case 8: return two_level_layout<VEC, 8>(q, norms, x, gmin, smin, nq, n, d, layout, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_chunked(const void* q, const void* norms, const void* x, void* out, int nq,
                           long long n, int d, cudaStream_t stream) {
  constexpr int TQ = (THREADS / (C / 16)) * 8;
  const long long ngroups = (n + GROUP - 1) / GROUP;
  const long long ntiles = (n + TILE_N - 1) / TILE_N;
  const int nqt = (nq + TQ - 1) / TQ;
  const size_t smem = (size_t)(KS * TQ + KS * C + TQ * C) * sizeof(float);
  auto kernel = groupmin_chunked_kernel<C>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(ntiles * nqt), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(norms), static_cast<const bf16*>(x),
      static_cast<float*>(out), nq, n, d, ngroups, nqt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every function takes a bf16 query (Q, d), f32 norms (N,) and a bf16 store
// (N, d), and returns the cudaError_t of its launch (0 = success).

// The CUDA-core kernels (chip_smoke.py's comparison). qt: queries per block
// (1, 2, 4 or 8); vec: 8 when rows are 16-byte aligned, else 1.

int ise_groupmin_width(const void* q, const void* norms, const void* x, void* out, int nq,
                       long long n, int d, int group, int qt, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 128) return width_vec<128>(q, norms, x, out, nq, n, d, qt, vec, s);
  if (group == 64) return width_vec<64>(q, norms, x, out, nq, n, d, qt, vec, s);
  if (group == 32) return width_vec<32>(q, norms, x, out, nq, n, d, qt, vec, s);
  return cudaErrorInvalidValue;
}

// layout: 0 = v1, 1 = v2 (both smin (Q, nsub)), 2 = v3 (smin (nsub, Q)).
int ise_groupmin_two_level(const void* q, const void* norms, const void* x, void* gmin,
                           void* smin, int nq, long long n, int d, int layout, int qt, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) return two_level_qt<8>(q, norms, x, gmin, smin, nq, n, d, layout, qt, s);
  if (vec == 1) return two_level_qt<1>(q, norms, x, gmin, smin, nq, n, d, layout, qt, s);
  return cudaErrorInvalidValue;
}

// d a multiple of 8 and rows 16-byte aligned (the wrapper checks).
int ise_groupmin_chunked(const void* q, const void* norms, const void* x, void* out, int nq,
                         long long n, int d, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 512) return launch_chunked<512>(q, norms, x, out, nq, n, d, s);
  if (chunk == 1024) return launch_chunked<1024>(q, norms, x, out, nq, n, d, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
