// The flat search's phase-1 group-min sweep on Hopper's tensor cores, one
// template for a bf16 store (topk_twophase.cu, mma.sync m16n8k16, f32
// sums) and an int8 store (topk_twophase_q8.cu, m16n8k32, exact s32 sums).
// It replaces image_search_engine_tpu/ops/topk_pallas.py _groupmin_kernel
// and _groupmin_kernel_q8: for each query and each 128-row group of the
// store, the min over the group of the row scores,
//
//   bf16  norms[r] - 2 q.x[r]                          (score_of)
//   int8  norms[r] - f32(q.x[r]) * ((2 qscale) * scales[r])  (score_q8)
//
// with queries as A and store rows as B (mma.cuh). The tile arithmetic
// (query tile, padded d, k-chunk, slice, shared memory) is
// ops/topk.py mma_plan, which counts it in bytes, so both dtypes share it.
//
// Block b takes query tile b % nqt (BQ queries) and the slice of `gps`
// 128-row groups b / nqt, so the nqt blocks that read one slice run together
// and find it in L2. Each group's rows come in as k-chunks of kc elements
// (the whole padded row when it fits), cp.async double-buffered: chunk i + 1
// loads while chunk i is multiplied. RESIDENT: the query tile stays in
// shared memory for the whole block (a batch of fewer than BQ queries stages
// only its own rows and one zero row, which the A rows past them read).
// Otherwise, where a resident tile of wide rows would leave an SM room for
// one block only, each stage holds the query tile's k-chunk beside the
// store's: the store is still read once per BQ queries, and two blocks share
// an SM. 8 warps split the BQ x 128 output tile, WM along the queries and WN
// along the group's rows, each warp summing the whole of dp for its own tile
// in ascending 32-byte k-steps (mma_steps); d is zero-padded to whole
// k-steps in shared memory, and the zeros add exactly 0. The epilogue works
// on the accumulator fragment: rows past n score +inf, each thread takes the
// min over its columns, then over the four lanes of its quad with shuffles,
// into shared memory (red) one min per warp along the group's rows and
// query. An output policy (Epi) turns those into the kernel's outputs, for
// queries < nq only:
//
//   QueryMajorMins  the 128-row group mins, query-major out[q * ngroups + g]
//                   (the search's phase 1; the default)
//   WidthMins<G>    the G-row group mins, G in {128, 64, 32}, group-major
//                   out[g * nq + q] (groupmin_variants.cu)
//   TwoLevelMins<L> the 128-row group mins group-major, and the 32-row
//                   subgroup mins rounded to bf16 in layout L
//                   (groupmin_variants.cu)
//
// A warp holds 128 / WN contiguous rows (32 with BQ >= 32, 16 with BQ =
// 16), so a G-row or 32-row min is the fminf of whole warps' entries, and
// every 128-row min is the fminf of the WN entries in the order production
// takes them: the same bits from every policy.
//
// The bf16 rescore (topk_twophase.cu rescore_mma_kernel) runs the same
// mma_steps with each row in the lane and register this sweep gives it; the
// int8 rescore (rescore_q8_kernel) sums the same codes with __dp4a, which
// gives the same int32, and runs the same score_q8. Either way a group's
// phase-1 min is bit for bit the min of its phase-2 scores.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "scoring.cuh"

namespace {

constexpr int GROUP = 128;  // candidate-group width (rows)
constexpr int SUB = 32;     // subgroup width of the two-level outputs (rows)
constexpr int SUBS = GROUP / SUB;

template <int BQ>
struct MmaTile {
  static constexpr int WM = BQ >= 32 ? 2 : 1;  // warps along the queries
  static constexpr int WN = WARPS / WM;        // warps along the group's rows
  static constexpr int WTM = BQ / (16 * WM);   // 16-row A tiles per warp
  static constexpr int WTN = GROUP / (8 * WN); // 8-row B tiles per warp
};

// Shared-memory bytes of a sweep block over elements of esize bytes: the
// resident query tile min(bq, nq + 1) x dp (+ pad), two stages of 128 (+ bq
// streamed) rows x kc (+ pad), and WN x bq floats for the cross-warp min.
__host__ __device__ inline size_t groupmin_mma_smem(int bq, int nq, int dp, int kc, bool resident,
                                                    int esize) {
  const int wn = WARPS / (bq >= 32 ? 2 : 1);
  // query rows staged (the last zero when nq < bq), or streamed per stage
  const int qsrows = resident ? min(bq, nq + 1) : 0;
  const int srows = resident ? GROUP : GROUP + bq;
  return (size_t)qsrows * (dp * esize + SMEM_PAD_BYTES) +
         (size_t)2 * srows * (kc * esize + SMEM_PAD_BYTES) + (size_t)wn * bq * 4;
}

// ---- output policies (the epilogue) ----
//
// group() runs, with every thread of the block, once a group g (the gl-th
// of the block's slice) is swept, after a barrier: red[w * BQ + r] is then
// the min, for the tile's query r, over the rows of warp w (rows w * 128 /
// WN onwards), +inf past n. STAGED: shared-memory bytes per query of the
// tile that the policy keeps after red (kept) for the whole block.

// The 128-row group mins, query-major out[q * ngroups + g].
struct QueryMajorMins {
  static constexpr int STAGED = 0;
  template <int BQ, int WN>
  static __device__ __forceinline__ void group(const float* red, __nv_bfloat16*,
                                               float* __restrict__ out, __nv_bfloat16* __restrict__,
                                               int q0, int nq, int g, int, int, int ngroups,
                                               long long) {
    for (int r = threadIdx.x; r < BQ && q0 + r < nq; r += THREADS) {
      float m = red[r];
#pragma unroll
      for (int w = 1; w < WN; ++w) m = fminf(m, red[w * BQ + r]);
      out[(size_t)(q0 + r) * ngroups + g] = m;
    }
  }
};

// The G-row group mins, group-major out[g * nq + q] for the ceil(n / G)
// groups; a group with no row below n is not written.
template <int G>
struct WidthMins {
  static constexpr int STAGED = 0;
  template <int BQ, int WN>
  static __device__ __forceinline__ void group(const float* red, __nv_bfloat16*,
                                               float* __restrict__ out, __nv_bfloat16* __restrict__,
                                               int q0, int nq, int g, int, int, int, long long n) {
    constexpr int PER = GROUP / G;  // G-row groups per 128-row group
    constexpr int E = WN / PER;     // warps per G-row group
    static_assert(GROUP % G == 0 && WN % PER == 0, "a warp's rows lie in one G-row group");
    const long long ng = (n + G - 1) / G;
    for (int i = threadIdx.x; i < PER * BQ; i += THREADS) {
      const int r = i % BQ, j = i / BQ;  // neighbouring threads on neighbouring queries
      const long long gg = (long long)g * PER + j;
      if (q0 + r >= nq || gg >= ng) continue;
      float m = red[j * E * BQ + r];
#pragma unroll
      for (int w = 1; w < E; ++w) m = fminf(m, red[(j * E + w) * BQ + r]);
      out[gg * nq + q0 + r] = m;
    }
  }
};

// One sweep, two outputs: the 128-row group mins, group-major gmin[g * nq +
// q], and the 32-row subgroup mins rounded to nearest-even bf16 (as
// .to(torch.bfloat16), +-inf kept), of the nsub = ceil(n / 32) subgroups
// with a row below n. LAYOUT 0 (v1): query-major sub[q * nsub + s], a
// query's four of a group written as the group ends, by four neighbouring
// threads (8 contiguous bytes). 1 (v2): query-major, kept in shared memory
// for a run of RUN groups of the slice (BQ x 32 bf16: 8 KB at BQ = 128,
// which leaves the bench point's plan its 128-element chunk and two blocks
// an SM), then written as each query's run of up to 32 subgroups (64
// contiguous bytes). 2 (v3): subgroup-major sub[s * nq + q].
template <int LAYOUT>
struct TwoLevelMins {
  static_assert(LAYOUT >= 0 && LAYOUT <= 2, "v1, v2 or v3");
  static constexpr int RUN = 8;  // v2: groups per staged run
  static constexpr int STAGED = LAYOUT == 1 ? RUN * SUBS * (int)sizeof(__nv_bfloat16) : 0;
  template <int BQ, int WN>
  static __device__ __forceinline__ void group(const float* red, __nv_bfloat16* kept,
                                               float* __restrict__ gmin,
                                               __nv_bfloat16* __restrict__ sub, int q0, int nq,
                                               int g, int gl, int gps, int ngroups, long long n) {
    constexpr int E = WN / SUBS;  // warps per subgroup
    static_assert(WN % SUBS == 0, "a warp's rows lie in one subgroup");
    for (int r = threadIdx.x; r < BQ && q0 + r < nq; r += THREADS) {
      float m = red[r];
#pragma unroll
      for (int w = 1; w < WN; ++w) m = fminf(m, red[w * BQ + r]);
      gmin[(size_t)g * nq + q0 + r] = m;
    }
    const long long nsub = (n + SUB - 1) / SUB;
    for (int i = threadIdx.x; i < SUBS * BQ; i += THREADS) {
      // v3: neighbouring threads on neighbouring queries; v1, v2: on one query's subgroups
      const int r = LAYOUT == 2 ? i % BQ : i / SUBS;
      const int s = LAYOUT == 2 ? i / BQ : i % SUBS;
      const long long sg = (long long)g * SUBS + s;
      if (q0 + r >= nq || sg >= nsub) continue;
      float m = red[s * E * BQ + r];
#pragma unroll
      for (int w = 1; w < E; ++w) m = fminf(m, red[(s * E + w) * BQ + r]);
      const __nv_bfloat16 v = __float2bfloat16_rn(m);
      if constexpr (LAYOUT == 0)
        sub[(size_t)(q0 + r) * nsub + sg] = v;
      else if constexpr (LAYOUT == 1)
        kept[r * RUN * SUBS + (gl % RUN) * SUBS + s] = v;
      else
        sub[(size_t)sg * nq + q0 + r] = v;
    }
    if constexpr (LAYOUT == 1) {
      // the run's last group, or the slice's (the same for every thread): write the run
      const int last = min(g - gl + gps, ngroups) - 1;
      if (gl % RUN != RUN - 1 && g != last) return;
      __syncthreads();
      const int first = g - gl % RUN;
      const int width = (g - first + 1) * SUBS;  // this run's subgroups, per query
#pragma unroll 1  // unrolled, the loop takes v2 past 128 registers: one block an SM
      for (int i = threadIdx.x; i < BQ * RUN * SUBS; i += THREADS) {
        const int r = i / (RUN * SUBS), j = i % (RUN * SUBS);
        const long long sg = (long long)first * SUBS + j;
        if (j < width && q0 + r < nq && sg < nsub)
          sub[(size_t)(q0 + r) * nsub + sg] = kept[r * RUN * SUBS + j];
      }
    }
  }
};

// A tile plan the kernels can take: dp the padded d, kc a whole number of
// k-steps (kstep elements each), and the shared memory the plan reserved at
// least what the layout needs.
inline bool mma_plan_ok(int d, int dp, int kc, int kstep, size_t smem, size_t need) {
  return d > 0 && dp % kstep == 0 && dp >= d && dp - d < kstep && kc > 0 && kc % kstep == 0 &&
         smem >= need;
}

template <typename T, int BQ, int VEC, bool RESIDENT, class Epi>
__global__ void __launch_bounds__(THREADS)
    groupmin_mma_kernel(const T* __restrict__ q, const float* __restrict__ qscale,
                        const float* __restrict__ norms, const float* __restrict__ scales,
                        const T* __restrict__ x, float* __restrict__ out, int nq, long long n,
                        int d, int dp, int kc, int ngroups, int nqt, int gps,
                        __nv_bfloat16* __restrict__ sub) {
  using Op = MmaOf<T>;
  using Tile = MmaTile<BQ>;
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr int ES = (int)sizeof(T);
  constexpr int KSTEP = MMA_KBYTES / ES;  // elements per k-step
  constexpr int PAD = SMEM_PAD_BYTES / ES;
  constexpr int WN = Tile::WN, WTM = Tile::WTM, WTN = Tile::WTN;
  constexpr int AROWS = RESIDENT ? 0 : BQ;  // streamed query rows at the head of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int qst = dp + PAD;
  const int xst = kc + PAD;
  const int qsrows = RESIDENT ? min(BQ, nq + 1) : 0;
  T* qs = reinterpret_cast<T*>(smem);
  T* xs = qs + (size_t)qsrows * qst;
  const int srows = AROWS + GROUP;  // rows per stage
  float* red = reinterpret_cast<float*>(xs + (size_t)2 * srows * xst);
  // the policy's own Epi::STAGED bytes per query of the tile
  __nv_bfloat16* kept = reinterpret_cast<__nv_bfloat16*>(red + WN * BQ);

  const int qt = blockIdx.x % nqt;
  const int q0 = qt * BQ;
  const int qrows = min(BQ, nq - q0);  // this tile's queries
  const int g0 = (int)(blockIdx.x / nqt) * gps;
  const int g1 = min(g0 + gps, ngroups);
  const int nchunks = (dp + kc - 1) / kc;
  const int ntiles = (g1 - g0) * nchunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;

  auto fetch = [&](int i) {  // chunk i % nchunks of the slice's group i / nchunks
    const int c = i % nchunks;
    const int w = min(kc, dp - c * kc);
    const long long r0 = (long long)(g0 + i / nchunks) * GROUP;
    const int valid = (int)min((long long)GROUP, n - r0);
    T* stage = xs + (size_t)(i & 1) * srows * xst;
    if constexpr (!RESIDENT)
      load_tile<T, VEC>(stage, xst, q + (size_t)q0 * d, d, BQ, qrows, c * kc, w, d, threadIdx.x,
                        THREADS);
    load_tile<T, VEC>(stage + (size_t)AROWS * xst, xst, x + r0 * d, d, GROUP, valid, c * kc, w, d,
                      threadIdx.x, THREADS);
    cp_async_commit();
  };
  // a resident query tile goes out in the first commit group, with the
  // first chunk
  if constexpr (RESIDENT)
    load_tile<T, VEC>(qs, qst, q + (size_t)q0 * d, d, qsrows, qrows, 0, dp, d, threadIdx.x,
                      THREADS);
  fetch(0);

  uint32_t a[WTM];
#pragma unroll
  for (int mi = 0; mi < WTM; ++mi) {
    const int row = (wm * WTM + mi) * 16 + a_lane_row(lane);
    a[mi] = (RESIDENT ? smem_u32(qs + (size_t)(row < qrows ? row : qsrows - 1) * qst)
                      : smem_u32(xs + (size_t)row * xst)) +
            a_lane_byte(lane);
  }
  const uint32_t b_pair = 16 * xst * ES;
  const uint32_t stage_bytes = srows * xst * ES;
  const uint32_t b0 =
      smem_u32(xs + (size_t)(AROWS + wn * WTN * 8 + b_lane_row(lane)) * xst) + b_lane_byte(lane);
  // int8: 2 * the scale of each query whose scores this lane holds
  float qs2[WTM][2];
#pragma unroll
  for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + (wm * WTM + mi) * 16 + h * 8 + (lane >> 2);
      qs2[mi][h] = 0.f;
      if constexpr (Q8)
        if (qi < nq) qs2[mi][h] = __fmul_rn(2.f, __ldg(qscale + qi));
    }

  typename Op::Acc acc[WTM][WTN][4];
  zero_acc(acc);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = i % nchunks;
    const uint32_t stage = (uint32_t)(i & 1) * stage_bytes;
    uint32_t ac[WTM];
#pragma unroll
    for (int mi = 0; mi < WTM; ++mi)
      ac[mi] = a[mi] + (RESIDENT ? (uint32_t)c * kc * ES : stage);
    mma_steps<Op, WTM, WTN>(ac, b0 + stage, b_pair, min(kc, dp - c * kc) / KSTEP, acc);

    if (c == nchunks - 1) {  // the group's last chunk: its mins
      const int g = g0 + i / nchunks;
      const long long r0 = (long long)g * GROUP;
      float best[WTM][2];
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi) best[mi][0] = best[mi][1] = INFINITY;
#pragma unroll
      for (int ni = 0; ni < WTN; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long row = r0 + (wn * WTN + ni) * 8 + 2 * (lane & 3) + e;
          const bool ok = row < n;
          const float nr = ok ? __ldg(norms + row) : 0.f;
          float sc = 0.f;
          if constexpr (Q8) sc = ok ? __ldg(scales + row) : 0.f;
#pragma unroll
          for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float s;
              if constexpr (Q8)
                s = score_q8(nr, acc[mi][ni][2 * h + e], qs2[mi][h], sc);
              else
                s = score_of(nr, acc[mi][ni][2 * h + e]);
              best[mi][h] = fminf(best[mi][h], ok ? s : INFINITY);
            }
        }
      }
#pragma unroll
      for (int mi = 0; mi < WTM; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          best[mi][h] = fminf(best[mi][h], __shfl_xor_sync(0xffffffffu, best[mi][h], 1));
          best[mi][h] = fminf(best[mi][h], __shfl_xor_sync(0xffffffffu, best[mi][h], 2));
          if ((lane & 3) == 0)
            red[wn * BQ + (wm * WTM + mi) * 16 + h * 8 + (lane >> 2)] = best[mi][h];
        }
      __syncthreads();
      Epi::template group<BQ, WN>(red, kept, out, sub, q0, nq, g, g - g0, gps, ngroups, n);
      zero_acc(acc);
    }
    __syncthreads();  // every warp is done with stage i & 1 (and red) before it is refilled
  }
}

template <typename T, class Epi, int BQ, int VEC, bool RESIDENT>
cudaError_t launch_groupmin_mma(const void* q, const void* qscale, const void* norms,
                                const void* scales, const void* x, void* out, void* sub, int nq,
                                long long n, int d, int dp, int kc, int gps, size_t smem,
                                cudaStream_t stream) {
  const int ngroups = (int)((n + GROUP - 1) / GROUP);
  const int nqt = (nq + BQ - 1) / BQ;
  const long long grid = (long long)((ngroups + gps - 1) / gps) * nqt;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = groupmin_mma_kernel<T, BQ, VEC, RESIDENT, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qscale),
      static_cast<const float*>(norms), static_cast<const float*>(scales),
      static_cast<const T*>(x), static_cast<float*>(out), nq, n, d, dp, kc, ngroups, nqt, gps,
      static_cast<__nv_bfloat16*>(sub));
  return cudaGetLastError();
}

template <typename T, class Epi, int VEC, bool RESIDENT>
cudaError_t groupmin_mma_bq(const void* q, const void* qscale, const void* norms,
                            const void* scales, const void* x, void* out, void* sub, int nq,
                            long long n, int d, int bq, int dp, int kc, int gps, size_t smem,
                            cudaStream_t s) {
  switch (bq) {
    case 16:
      return launch_groupmin_mma<T, Epi, 16, VEC, RESIDENT>(q, qscale, norms, scales, x, out, sub,
                                                            nq, n, d, dp, kc, gps, smem, s);
    case 32:
      return launch_groupmin_mma<T, Epi, 32, VEC, RESIDENT>(q, qscale, norms, scales, x, out, sub,
                                                            nq, n, d, dp, kc, gps, smem, s);
    case 64:
      return launch_groupmin_mma<T, Epi, 64, VEC, RESIDENT>(q, qscale, norms, scales, x, out, sub,
                                                            nq, n, d, dp, kc, gps, smem, s);
    case 128:
      return launch_groupmin_mma<T, Epi, 128, VEC, RESIDENT>(q, qscale, norms, scales, x, out,
                                                             sub, nq, n, d, dp, kc, gps, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, class Epi, int VEC>
cudaError_t groupmin_mma_vec(const void* q, const void* qscale, const void* norms,
                             const void* scales, const void* x, void* out, void* sub, int nq,
                             long long n, int d, int bq, int dp, int kc, int gps, bool resident,
                             size_t smem, cudaStream_t s) {
  return resident ? groupmin_mma_bq<T, Epi, VEC, true>(q, qscale, norms, scales, x, out, sub, nq,
                                                       n, d, bq, dp, kc, gps, smem, s)
                  : groupmin_mma_bq<T, Epi, VEC, false>(q, qscale, norms, scales, x, out, sub, nq,
                                                        n, d, bq, dp, kc, gps, smem, s);
}

// The sweep on the tile plan of ops/topk.py mma_plan: bq queries per block
// (16, 32, 64 or 128), dp the padded d and kc the k-chunk (elements), gps
// groups per block, resident 1 to keep the query tile in shared memory (0:
// stream it beside the store), smem the dynamic shared memory (bytes, the
// policy's staging included). vec: elements per copy, 16 bytes of them
// (16-byte aligned rows of 16-byte multiples), 4 bytes, or 1. qscale and
// scales are read for int8 only; sub (bf16) by TwoLevelMins only.
template <typename T, class Epi = QueryMajorMins>
cudaError_t groupmin_mma(const void* q, const void* qscale, const void* norms, const void* scales,
                         const void* x, void* out, int nq, long long n, int d, int bq, int dp,
                         int kc, int gps, int resident, int smem, int vec, cudaStream_t s,
                         void* sub = nullptr) {
  constexpr int ES = (int)sizeof(T);
  constexpr int V16 = 16 / ES, V4 = 4 / ES;
  if (gps < 1 || !mma_plan_ok(d, dp, kc, MMA_KBYTES / ES, (size_t)smem,
                              groupmin_mma_smem(bq, nq, dp, kc, resident != 0, ES) +
                                  (size_t)bq * Epi::STAGED))
    return cudaErrorInvalidValue;
  if (vec == V16)
    return groupmin_mma_vec<T, Epi, V16>(q, qscale, norms, scales, x, out, sub, nq, n, d, bq, dp,
                                         kc, gps, resident != 0, smem, s);
  if (vec == V4)
    return groupmin_mma_vec<T, Epi, V4>(q, qscale, norms, scales, x, out, sub, nq, n, d, bq, dp,
                                        kc, gps, resident != 0, smem, s);
  if (vec == 1)
    return groupmin_mma_vec<T, Epi, 1>(q, qscale, norms, scales, x, out, sub, nq, n, d, bq, dp, kc,
                                       gps, resident != 0, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
