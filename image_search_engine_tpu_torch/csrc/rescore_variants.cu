// The phase-2 candidate rescore's prototype variants for Hopper (sm_90a), with
// a plain C interface for ctypes (ops/_kernels.py builds this file; ops/
// rescore_variants.py holds the wrappers and the plain PyTorch versions).
// Each takes a bf16 query (Q, d), a bf16 store (N, d) and per query t
// candidate 128-row groups cand (Q, t) int32, and scores every row of those
// groups, out (Q, t*128) f32 with column j*128 + r for row cand[:, j]*128 + r,
// as the production rescore kernel (topk_twophase.cu) lays it out:
//
//   rescore_gather  x.x - 2 q.x, the row's squared norm taken from the
//                   gathered bf16 row itself; rows at or past N score +inf.
//                   Replaces benchmarks/gather_kernel_proto.py:49
//                   rescore_kernel (launched :119) and
//                   benchmarks/gather_kernel_sweep2.py:40 rescore_kernel
//                   (launched :112), one body.
//   rescore_cross   the raw cross product q.x only (the caller adds the
//                   norms); rows at or past N write 0, what the TPU script's
//                   zero-padded store gives. Replaces
//                   benchmarks/rescore_dma_variants.py:33 _cross_only_kernel
//                   (launched :109).
//
// What bounds them on the H100: the gathered bytes. At bench.py's point (N =
// 1M, d = 128, Q = 2048, t = 12) the 24,576 picks read 32 KB each, 805 MB;
// they fall on at most 7,813 distinct groups (the 256 MB store), so the least
// the card could move is the distinct groups' bytes plus the 12.6 MB of
// scores (<= 0.080 ms at 3.35 TB/s). The products (2 or 4 per element, 0.2-0.4
// GFLOP) are nothing beside it.
//
// The group route (rescore_grouped_kernel, every caller's): the candidate
// slots are first put in group order (rescore_order_kernel below, a one-block
// counting sort in shared memory; ops/rescore_variants.py slot_order), so
// that the slots that picked one group sit side by side. Block b takes the ordered slots [b * QB, (b + 1) *
// QB), QB in {8, 16, 32}: the TPU grid step's QB (query, group) pairs, in
// group order. Within its range a block
//   * reads its slots' groups and splits them into runs of one group (a warp
//     ballot; ids outside [0, ngroups) write +inf or 0 and join no run);
//   * stages each run's group once, 128 rows x 128 columns a stage, by the
//     Tensor Memory Accelerator (one 2-D tensor map over the store, two
//     boxes of 64 columns in the 128-byte swizzle, rows past N zero-filled)
//     into a ring of stages (two: the next run's group is in flight while
//     this one is scored; one for QB = 8, whose few runs gain less from it
//     than from a fourth block an SM); rows of no 16-byte multiple (d = 130) are copied by the
//     block's threads into the same layout instead, one stage at a time;
//   * stages its slots' query rows once, bf16 in padded rows, and scores a
//     staged group against all of a run's queries on the tensor cores:
//     mma.sync m16n8k16 (mma.cuh), the group's rows as A (each warp 16 of
//     them, ldmatrix through the swizzle: conflict-free), the run's queries
//     as B (8 a tile), f32 accumulate. The gather kernel squares the A
//     fragments it already holds, so x.x is summed once per staged row for
//     every slot of the run;
//   * writes each slot's 128 scores at out[slot * 128 + r], streamed past L2.
// So a group is read from device memory about once per batch: a run that
// crosses a range boundary is staged once per range, mostly from L2, since
// neighbouring ranges run together, and a group that many queries picked
// spreads over many blocks. The bf16 products are exact in f32; only the
// order of the f32 sums differs from the plain version's.
//
// The slot route (rescore_variant_kernel, the design it replaced; only
// chip_smoke.py's comparison takes it, through rescore_variants.ROUTE): one
// block per (block of QB queries, candidate slot), so a group is read once
// for every query that picked it:
//   * the block stages its QB query rows in shared memory, widened to f32
//     (exact; <= 32 x d x 4 bytes);
//   * each half-warp scores one row: at d = 128 a bf16 row is 256 bytes, 16
//     lanes x one 16-byte load, so a warp reads two neighbouring rows of one
//     group, 512 contiguous bytes. Rows that are not 16-byte multiples at
//     16-byte aligned addresses take scalar loads;
//   * q.x and, for the gather kernel, x.x accumulate in f32 FMAs over the
//     row's widened values, then a butterfly within the half-warp; the score
//     is x.x - 2 q.x rounded once.
// Both routes are these kernels' own row routines: scoring.cuh's row_dot (a
// warp per row) stays as it is, since the production certificate rests on
// phase 1 and phase 2 sharing it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

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


// ---- the group route's slot order ----
//
// The flat candidate slots grouped by group id, groups ascending (ids below
// 0 first, ids of ng or more last), by a counting sort in one block whose
// bins and order stay in shared memory: each thread counts its slots into the
// bins (ORDER_UNROLL loads in flight before their atomics), an exclusive scan
// turns the counts into offsets, each slot takes the next place of its bin
// (so the order within a group varies, which the scores do not depend on),
// and the order leaves in one coalesced pass. ops/topk.py group_order, which
// production's rescore_q8 and probed scan use, keeps its bins in device
// memory and waits on an atomic's return in device memory for every slot, a
// time that grows with the slots until it rivals the rescore's own at bench.py's
// point (PERF.md, rows 14-16). ops/rescore_variants.py slot_order calls this
// kernel where bins and order fit (ORDER_SMEM_BYTES), else group_order.
constexpr int ORDER_BLOCK = 1024;
constexpr int ORDER_UNROLL = 8;

__device__ __forceinline__ int slot_bin(int g, int ng) {
  return g < 0 ? 0 : (g < ng ? g + 1 : ng + 1);
}

__global__ void __launch_bounds__(ORDER_BLOCK)
    rescore_order_kernel(const int* __restrict__ cand, int* __restrict__ order, int slots,
                         int ng) {
  extern __shared__ int order_smem[];  // ng + 2 bins, then the order
  __shared__ int wsum[ORDER_BLOCK / 32];
  int* bins = order_smem;
  int* ord = order_smem + ng + 2;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nb = ng + 2;
  for (int b = tid; b < nb; b += ORDER_BLOCK) bins[b] = 0;
  __syncthreads();
  for (int i0 = tid; i0 < slots; i0 += ORDER_BLOCK * ORDER_UNROLL) {
    int b[ORDER_UNROLL];
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; ++u) {
      const int i = i0 + u * ORDER_BLOCK;
      b[u] = i < slots ? slot_bin(__ldg(cand + i), ng) : -1;
    }
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; ++u)
      if (b[u] >= 0) atomicAdd(bins + b[u], 1);
  }
  __syncthreads();
  // exclusive scan: thread tid owns bins [b0, b1)
  const int per = (nb + ORDER_BLOCK - 1) / ORDER_BLOCK;
  const int b0 = min(nb, tid * per);
  const int b1 = min(nb, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += bins[b];
  int x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int run = x - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int b = b0; b < b1; ++b) {
    const int c = bins[b];
    bins[b] = run;
    run += c;
  }
  __syncthreads();
  for (int i0 = tid; i0 < slots; i0 += ORDER_BLOCK * ORDER_UNROLL) {
    int b[ORDER_UNROLL];
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; ++u) {
      const int i = i0 + u * ORDER_BLOCK;
      b[u] = i < slots ? slot_bin(__ldg(cand + i), ng) : -1;
    }
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; ++u)
      if (b[u] >= 0) ord[atomicAdd(bins + b[u], 1)] = i0 + u * ORDER_BLOCK;
  }
  __syncthreads();
  for (int i = tid; i < slots; i += ORDER_BLOCK) order[i] = ord[i];
}

// ---- the group route ----

constexpr int G_SPAN = 128;                     // bytes of a row per swizzle span (64 bf16)
constexpr int G_SPAN_COLS = G_SPAN / 2;         // a TMA box's columns
constexpr int G_CHUNK_COLS = 2 * G_SPAN_COLS;   // columns of one stage: two spans
constexpr int G_SPAN_BYTES = GROUP * G_SPAN;    // one box: 128 rows x 128 bytes
constexpr int G_STAGE_BYTES = 2 * G_SPAN_BYTES;  // 32 KB
constexpr int G_MAX_STAGES = 4;
constexpr int G_ALIGN = 1024;  // the 128-byte swizzle's destination alignment

// Dynamic shared memory of the group route: the alignment slack, the ring,
// then QB query rows of dp = d rounded up to 16 bf16 (zeros past d), each
// padded by SMEM_PAD_BYTES (ops/rescore_variants.py grouped_plan: the same sum).
__host__ __device__ constexpr size_t grouped_smem(int qb, int d, int stages) {
  return (size_t)G_ALIGN + (size_t)stages * G_STAGE_BYTES +
         (size_t)qb * ((size_t)(d + 15) / 16 * 32 + SMEM_PAD_BYTES);
}

// Item i's chunk (columns c0 = (i % nk) * 128 on, the spans that hold
// columns below dp) of group g into ring stage i % stages, counted on that
// stage's barrier: one 128-row box of the tensor map per span (rows past N
// zero-filled; the barrier counts whole boxes). One thread issues it.
__device__ __forceinline__ void grouped_issue(const CUtensorMap* xmap, unsigned char* ring,
                                              uint64_t* full, int i, int g, int nk, int dp,
                                              int stages) {
  const int st = i % stages;
  const int c0 = (i % nk) * G_CHUNK_COLS;
  const int nsp = min(2, (dp - c0 + G_SPAN_COLS - 1) / G_SPAN_COLS);
  const uint32_t bar = smem_u32(&full[st]);
  mbar_expect_tx(bar, (uint32_t)nsp * G_SPAN_BYTES);
  for (int sp = 0; sp < nsp; ++sp)
    tma_load_2d(smem_u32(ring + (size_t)st * G_STAGE_BYTES + sp * G_SPAN_BYTES), xmap, bar,
                c0 + sp * G_SPAN_COLS, g * GROUP);
}

// Block b scores the ordered slots [b * QB, b * QB + QB) of order (slots of
// cand, flat, in group order). Item i of the block is column chunk i % nk of
// run i / nk; a warp's 16 rows of the chunk are A (ldmatrix, 16-byte chunk j
// of row r at chunk j ^ (r % 8) of its span), the run's query rows B.
template <int QB, bool GATHER>
__global__ void __launch_bounds__(THREADS)
    rescore_grouped_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ q,
                           const bf16* __restrict__ x, const int* __restrict__ cand,
                           const int* __restrict__ order, float* __restrict__ out,
                           long long slots, long long n, int d, int t, int ng, int stages,
                           int tma) {
  static_assert(QB <= 32, "a block's slots are one warp's lanes");
  constexpr int NP = (QB + 15) / 16;  // pairs of 8-query B tiles a run can need
  extern __shared__ __align__(16) unsigned char grouped_smem_raw[];
  __shared__ __align__(8) uint64_t full[G_MAX_STAGES];
  __shared__ int sl[QB], gr[QB], run_at[QB + 1], nruns;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(grouped_smem_raw) + G_ALIGN - 1) & ~uintptr_t(G_ALIGN - 1));
  const int dp = (d + 15) / 16 * 16;
  const int qstride = dp * 2 + SMEM_PAD_BYTES;  // bytes of a staged query row
  unsigned char* qs = ring + (size_t)stages * G_STAGE_BYTES;
  const long long first = (long long)blockIdx.x * QB;
  const int cnt = (int)(slots - first < QB ? slots - first : QB);
  const int nk = (dp + G_CHUNK_COLS - 1) / G_CHUNK_COLS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 0) {  // the block's slots, their groups and runs; the first stages' copies
    int s = -1, g = -1;
    if (lane < cnt) {
      s = __ldg(order + first + lane);
      g = __ldg(cand + s);
    }
    const bool valid = lane < cnt && g >= 0 && g < ng;
    const int gprev = __shfl_up_sync(0xffffffffu, g, 1);
    const bool start = valid && (lane == 0 || gprev != g);  // the slot before is another group
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned valids = __ballot_sync(0xffffffffu, valid);
    if (lane < QB) {
      sl[lane] = s;
      gr[lane] = g;
    }
    if (start) run_at[__popc(starts & ((1u << lane) - 1u))] = lane;
    if (lane == 0) {
      // the valid slots are one stretch (ids below 0 sort first, ids of ng or more last)
      run_at[__popc(starts)] = valids ? 32 - __clz(valids) : 0;
      nruns = __popc(starts);
    }
    __syncwarp();
    if (lane == 0 && tma) {
      for (int st = 0; st < stages; ++st) mbar_init(smem_u32(&full[st]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const int items = nruns * nk;
      for (int i = 0; i < stages && i < items; ++i)
        grouped_issue(&xmap, ring, full, i, gr[run_at[i / nk]], nk, dp, stages);
    }
  }
  __syncthreads();

  // the slots' query rows, zero past d; slots of no group score past N whole
  constexpr float PAST = GATHER ? INFINITY : 0.f;
  const int per_row = dp / 8;  // 16-byte units of a staged row
  const bool q16 = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  for (int i = threadIdx.x; i < cnt * per_row; i += THREADS) {
    const int p = i / per_row;
    const int c = (i - p * per_row) * 8;
    const bf16* src = q + (size_t)(sl[p] / t) * d + c;
    uint4 v;
    if (q16 && c < d) {
      v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = c + j < d ? __ldg(reinterpret_cast<const uint16_t*>(src) + j) : (uint16_t)0;
      v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                     e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)p * qstride + c * 2) = v;
  }
  for (int i = threadIdx.x; i < cnt * GROUP; i += THREADS) {
    const int p = i / GROUP;
    if (gr[p] < 0 || gr[p] >= ng) __stcs(out + (size_t)sl[p] * GROUP + i % GROUP, PAST);
  }
  __syncthreads();

  const int items = nruns * nk;
  const int ar = warp * 16 + (lane & 15);  // this lane's A row for ldmatrix
  const int g8 = lane / 4;
  const int tig = lane % 4;
  float acc[2 * NP][4];
  float xx0 = 0.f, xx1 = 0.f;  // x.x of rows warp * 16 + g8 and + 8 (this lane's share)
  for (int i = 0; i < items; ++i) {
    const int run = i / nk;
    const int kc = i % nk;
    const int st = tma ? i % stages : 0;
    const int p0 = run_at[run];
    const int len = run_at[run + 1] - p0;
    const int g = gr[p0];
    const int c0 = kc * G_CHUNK_COLS;
    unsigned char* stage = ring + (size_t)st * G_STAGE_BYTES;
    if (tma) {
      mbar_wait(smem_u32(&full[st]), (uint32_t)(i / stages) & 1u);
    } else {  // element by element, in the swizzle the Tensor Memory Accelerator writes
      const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
      for (int e = threadIdx.x; e < GROUP * G_CHUNK_COLS; e += THREADS) {
        const int r = e / G_CHUNK_COLS;
        const int c = e - r * G_CHUNK_COLS;
        const long long row = (long long)g * GROUP + r;
        const int byte = (c % G_SPAN_COLS) * 2;
        *reinterpret_cast<uint16_t*>(stage + (c / G_SPAN_COLS) * G_SPAN_BYTES + r * G_SPAN +
                                     ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))) =
            row < n && c0 + c < d ? xr[row * d + c0 + c] : (uint16_t)0;
      }
      __syncthreads();
    }
    if (kc == 0) {
#pragma unroll
      for (int jt = 0; jt < 2 * NP; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
      xx0 = xx1 = 0.f;
    }
    const int npairs = (len + 15) / 16;
    const int ksteps = min(G_CHUNK_COLS, dp - c0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4];
      const int j = (ks % 4) * 2 + lane / 16;  // the lane's 16-byte chunk of the span's row
      ldmatrix_x4(smem_u32(stage + (ks / 4) * G_SPAN_BYTES + ar * G_SPAN + ((j ^ (ar & 7)) << 4)),
                  a);
      if (GATHER) {  // rows g8 (a0, a2) and g8 + 8 (a1, a3)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[e]));
          float& xx = e % 2 ? xx1 : xx0;
          xx = fmaf(f.x, f.x, xx);
          xx = fmaf(f.y, f.y, xx);
        }
      }
#pragma unroll
      for (int jp = 0; jp < NP; ++jp) {
        if (jp < npairs) {
          const int brow = min(p0 + 16 * jp + b_lane_row(lane), cnt - 1);
          uint32_t b[4];
          ldmatrix_x4(smem_u32(qs + (size_t)brow * qstride + (c0 + ks * 16) * 2) +
                          b_lane_byte(lane),
                      b);
          MmaBf16::mma(a, b[0], b[1], acc[2 * jp]);
          MmaBf16::mma(a, b[2], b[3], acc[2 * jp + 1]);
        }
      }
    }
    if (kc == nk - 1) {  // the run's scores: acc[jt][e] is row g8 + 8 (e / 2) of the
                         // warp's 16, the run's slot 8 jt + 2 tig + e % 2
      if (GATHER) {
        xx0 += __shfl_xor_sync(0xffffffffu, xx0, 1);
        xx0 += __shfl_xor_sync(0xffffffffu, xx0, 2);
        xx1 += __shfl_xor_sync(0xffffffffu, xx1, 1);
        xx1 += __shfl_xor_sync(0xffffffffu, xx1, 2);
      }
#pragma unroll
      for (int jt = 0; jt < 2 * NP; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jt + 2 * tig + e % 2;
          const int r = warp * 16 + g8 + 8 * (e / 2);
          if (col < len) {
            const bool in = (long long)g * GROUP + r < n;
            float v;
            if (GATHER) {
              v = in ? score_of(e / 2 ? xx1 : xx0, acc[jt][e]) : INFINITY;
            } else {
              v = in ? acc[jt][e] : 0.f;
            }
            __stcs(out + (size_t)sl[p0 + col] * GROUP + r, v);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    const int next = i + stages;
    if (tma && threadIdx.x == 0 && next < items)
      grouped_issue(&xmap, ring, full, next, gr[run_at[next / nk]], nk, dp, stages);
  }
}

template <int QB, bool GATHER>
cudaError_t launch_grouped(const void* q, const void* x, const void* cand, const void* order,
                           void* out, int nq, long long n, int d, int t, int stages, int smem,
                           int tma, cudaStream_t stream) {
  const long long slots = (long long)nq * t;
  const long long blocks = (slots + QB - 1) / QB;
  const long long ng = (n + GROUP - 1) / GROUP;
  if (t <= 0 || d <= 0 || blocks > INT_MAX || ng > INT_MAX || stages < 1 ||
      stages > G_MAX_STAGES || smem < 0 || (size_t)smem < grouped_smem(QB, d, stages))
    return cudaErrorInvalidValue;
  CUtensorMap xmap = {};
  if (tma && (d % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || n > INT_MAX - GROUP ||
              !tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, d, n, G_SPAN_COLS,
                             GROUP, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  auto kernel = rescore_grouped_kernel<QB, GATHER>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      xmap, static_cast<const bf16*>(q), static_cast<const bf16*>(x),
      static_cast<const int*>(cand), static_cast<const int*>(order), static_cast<float*>(out),
      slots, n, d, t, (int)ng, stages, tma);
  return cudaGetLastError();
}

template <bool GATHER>
cudaError_t grouped_kind(const void* q, const void* x, const void* cand, const void* order,
                         void* out, int nq, long long n, int d, int t, int qb, int stages,
                         int smem, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISE_GROUPED(QB) \
  launch_grouped<QB, GATHER>(q, x, cand, order, out, nq, n, d, t, stages, smem, tma, s)
  switch (qb) {
    case 8: return ISE_GROUPED(8);
    case 16: return ISE_GROUPED(16);
    case 32: return ISE_GROUPED(32);
    default: return cudaErrorInvalidValue;
  }
#undef ISE_GROUPED
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

// The group route: order is ops/rescore_variants.py slot_order(cand, ngroups),
// the flat slots in group order; stages: ring stages (1 to 4); smem: at least
// grouped_smem(qb, d, stages); tma 1 for rows the Tensor Memory Accelerator
// can tile (d % 8 == 0, x 16-byte aligned, N < 2^31), else 0. ops/
// rescore_variants.py grouped_plan gives stages and smem.

int ise_rescore_gather_grouped(const void* q, const void* x, const void* cand, const void* order,
                               void* out, int nq, long long n, int d, int t, int qb, int stages,
                               int smem, int tma, void* stream) {
  return grouped_kind<true>(q, x, cand, order, out, nq, n, d, t, qb, stages, smem, tma, stream);
}

int ise_rescore_cross_grouped(const void* q, const void* x, const void* cand, const void* order,
                              void* out, int nq, long long n, int d, int t, int qb, int stages,
                              int smem, int tma, void* stream) {
  return grouped_kind<false>(q, x, cand, order, out, nq, n, d, t, qb, stages, smem, tma, stream);
}

// The group route's slot order: order (slots int32) = the flat slots of
// cand in group order. smem: dynamic shared memory, at least (ng + 2 +
// slots) * 4 bytes (ops/rescore_variants.py slot_order).
int ise_rescore_order(const void* cand, void* order, int slots, int ng, int smem, void* stream) {
  if (slots <= 0 || ng < 0 || smem < 0 || (long long)smem < ((long long)ng + 2 + slots) * 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rescore_order_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rescore_order_kernel<<<1, ORDER_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<int*>(order), slots, ng);
  return cudaGetLastError();
}

}  // extern "C"
