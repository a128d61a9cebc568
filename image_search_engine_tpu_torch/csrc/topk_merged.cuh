// The merged search's scheduler and kernels (topk_merged.cu describes the
// design), shared by its sources, which build in parallel: topk_merged.cu
// (the entry point and the CUDA-core route), topk_merged_mma<bq>.cu (the
// bf16 tensor-core route, one source per query tile) and
// topk_merged_tf32.cu (the f32 warpgroup-MMA route). Here: the launch's
// arguments, its work items and their order (next_item; ops/topk_merged.py
// MergedPlan.phases), the waits and the publishing of finished items, a
// select item's routine, and the bf16 route's kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "groupmin_mma.cuh"
#include "select_radix.cuh"
#include "twophase.cuh"

// The launch's arguments, one type in every source that includes this.
namespace ise_merged {

struct MergedArgs {
  const void* q;  // queries in the store dtype (routes 0, 1)
  const float* norms;
  const void* x;
  float* mins;       // (nq, ngroups)
  int* cand;         // (nq, t)
  float* thr;        // (nq,)
  float* scores;     // (nq, t * 128)
  float* vals;       // (nq, t) scratch: the selected mins
  uint64_t* sort_g;  // (nq, 2t) scratch for t > SEL_BIG_T_MAX
  int* counters;  // [0] ticket, [1, 1 + units) sweep items done, then a flag a query
  int nq;
  long long n;
  int d;
  int t;
  int ngroups;
  int bq;       // queries per tile
  int nqt;      // query tiles
  int gps;      // groups per sweep item
  int nslices;  // sweep items per query tile
  int tpu;      // query tiles per unit
  int units;
  int dp;   // route 1: padded d
  int kc;   // route 1: the sweep's k-chunk
  int rkc;  // route 1: the rescore's k-chunk
};

// Route 1's launch on query tiles of 16, 32, 64 or 128 queries, each in a
// source of its own (topk_merged_mma<bq>.cu) so that they build in
// parallel: merged_mma_kernel<bq, vec, resident> on grid blocks of smem
// bytes of dynamic shared memory.
cudaError_t launch_mma16(const MergedArgs& a, int vec, bool resident, int grid, int smem,
                         cudaStream_t s);
cudaError_t launch_mma32(const MergedArgs& a, int vec, bool resident, int grid, int smem,
                         cudaStream_t s);
cudaError_t launch_mma64(const MergedArgs& a, int vec, bool resident, int grid, int smem,
                         cudaStream_t s);
cudaError_t launch_mma128(const MergedArgs& a, int vec, bool resident, int grid, int smem,
                          cudaStream_t s);

}  // namespace ise_merged

namespace {

using ise_merged::MergedArgs;

enum Route { ROUTE_CUDA = 0, ROUTE_MMA = 1, ROUTE_TF32 = 2 };
enum Kind { ITEM_SWEEP = 0, ITEM_SELECT = 1, ITEM_RESCORE = 2, ITEM_DONE = 3 };

// The select's shared state at the head of its shared memory, then its
// scratch (select_radix_block).
constexpr size_t SEL_SHARED_BYTES = (sizeof(SelectShared) + 15) & ~(size_t)15;

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Shared-memory bytes of a select item for t.
__host__ __device__ inline size_t merged_select_smem(int t) {
  return SEL_SHARED_BYTES + SEL_CAND_BYTES + sort_bytes(t);
}

// A work item, as the block's scheduling thread hands it to the others.
// sweep: index = the sweep kernel's block index; select: index = the
// query; rescore: index = the first slot (route 0: the rescore kernel's
// block index), count slots (route 1: 1 or 2), g their candidate groups.
struct MergedItem {
  int kind;
  int unit;
  int index;
  int count;
  int g[2];
};

// Unit u: query tiles [u * tpu, min(nqt, (u + 1) * tpu)), queries from
// u * tpu * bq; rescore items per query slot: route 0 four (32 rows each),
// route 1 a half (two pairs a block), route 2 one.
struct Sched {
  const MergedArgs& a;
  int route;
  __device__ int tiles(int u) const { return min(a.nqt, (u + 1) * a.tpu) - u * a.tpu; }
  __device__ int q_lo(int u) const { return u * a.tpu * a.bq; }
  __device__ int queries(int u) const { return min(a.nq, (u + 1) * a.tpu * a.bq) - q_lo(u); }
  __device__ int sweeps(int u) const { return a.nslices * tiles(u); }
  __device__ int rescores(int u) const {
    const int slots = queries(u) * a.t;
    return route == ROUTE_CUDA ? slots * RESCORE_SPLIT
                               : (route == ROUTE_MMA ? (slots + 1) / 2 : slots);
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spins a wait may take, some seconds: far beyond any unit's sweep. A wait
// that outlasts them traps (the launch fails and the wrapper raises) rather
// than hold the card.
constexpr long long WAIT_MAX_SPINS = 1ll << 24;

// until *p >= want (written by other blocks of this launch)
__device__ __forceinline__ void wait_count(const int* p, int want) {
  for (long long spins = 0; load_acquire(p) < want; ++spins) {
    if (spins == WAIT_MAX_SPINS) __trap();
    __nanosleep(64);
  }
}

// The rescore item j of unit u: its slot(s) (route 0: the rescore kernel's
// block), after the select flags of their queries, and their candidate
// groups, read through L2.
template <int kRoute>
__device__ __forceinline__ MergedItem rescore_item(const MergedArgs& a, const Sched& sc, int u,
                                                   int j) {
  const int* sel_flags = a.counters + 1 + a.units;
  const int first = sc.q_lo(u) * a.t;  // the unit's first slot
  MergedItem it{ITEM_RESCORE, u, 0, 1, {0, 0}};
  if (kRoute == ROUTE_CUDA) {
    it.index = first * RESCORE_SPLIT + j;
    const int slot = it.index / RESCORE_SPLIT;
    wait_count(sel_flags + slot / a.t, 1);
    it.g[0] = __ldcg(a.cand + slot);
  } else {
    const int per = kRoute == ROUTE_MMA ? 2 : 1;
    it.index = first + per * j;
    it.count = min(per, first + sc.queries(u) * a.t - it.index);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e >= it.count) break;
      wait_count(sel_flags + (it.index + e) / a.t, 1);
      it.g[e] = __ldcg(a.cand + it.index + e);
    }
  }
  return it;
}

// The sweep item j of unit u: the sweep kernel's block (slice j / tiles,
// tile j % tiles of the unit's).
__device__ __forceinline__ MergedItem sweep_item(const MergedArgs& a, const Sched& sc, int u,
                                                 int j) {
  const int ntu = sc.tiles(u);
  return MergedItem{ITEM_SWEEP, u, (j / ntu) * a.nqt + u * a.tpu + j % ntu, 1, {0, 0}};
}

// The next work item of the block (called by one thread): a ticket, its
// item in the order the header describes (ops/topk_merged.py
// MergedPlan.phases), and, before the item is handed out, the waits it
// needs and the candidate groups of a rescore item.
template <int kRoute>
__device__ MergedItem next_item(const MergedArgs& a) {
  const Sched sc{a, kRoute};
  int left = atomicAdd(a.counters, 1);
  for (int step = 0; step <= a.units; ++step) {
    if (step < a.units) {
      if (left < sc.sweeps(step)) return sweep_item(a, sc, step, left);
      left -= sc.sweeps(step);
    }
    if (step == 0) continue;
    const int u = step - 1;
    if (left < sc.queries(u)) {
      wait_count(a.counters + 1 + u, sc.sweeps(u));
      return MergedItem{ITEM_SELECT, u, sc.q_lo(u) + left, 1, {0, 0}};
    }
    left -= sc.queries(u);
    if (left < sc.rescores(u)) return rescore_item<kRoute>(a, sc, u, left);
    left -= sc.rescores(u);
  }
  return MergedItem{ITEM_DONE, 0, 0, 0, {0, 0}};
}

// Makes this block's writes of an item visible (every writer fences, then
// the barrier `sync`), then adds one to *count for the items waiting on it.
template <class Sync>
__device__ __forceinline__ void publish(int* count, Sync sync) {
  __threadfence();
  sync();
  if (threadIdx.x == 0) atomicAdd(count, 1);
}

// The select of query qi on SEL_THREADS threads (barrier kBar,
// select_radix.cuh) in the shared memory at smem, the row read from L2
// (it was written in this launch; one select routine in each kernel keeps
// the build short): cand[qi] the t smallest of the row's group mins in
// ascending (value, group id) order, thr[qi] the t-th; when t = ngroups
// every group in order and +inf. vals (nq, t) scratch, sort_g as
// select_radix_block's.
template <int kBar>
__device__ __forceinline__ void select_query(const MergedArgs& a, int qi, unsigned char* smem) {
  int* ids = a.cand + (size_t)qi * a.t;
  if (a.t == a.ngroups) {
    for (int j = threadIdx.x; j < a.t; j += SEL_THREADS) ids[j] = j;
    if (threadIdx.x == 0) a.thr[qi] = INFINITY;
    return;
  }
  SelectShared& s = *reinterpret_cast<SelectShared*>(smem);
  select_radix_block<false, true, kBar, false>(a.mins, a.vals, a.cand, nullptr, nullptr, nullptr,
                                               a.sort_g, a.ngroups, a.t, 1, a.ngroups, qi,
                                               smem + SEL_SHARED_BYTES, s);
  // the select ends with a barrier: its t-th value is in L2
  if (threadIdx.x == 0) a.thr[qi] = __ldcg(a.vals + (size_t)qi * a.t + a.t - 1);
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The launch's arguments from an entry point's (ise_topk_merged,
// ise_topk_merged_tf32); false where the plan cannot be right.
inline bool merged_args(MergedArgs& a, int route, const void* q, const void* norms, const void* x,
                        void* mins, void* cand, void* thr, void* scores, void* vals, void* sort_g,
                        void* counters, int nq, long long n, int d, int t, int bq, int gps,
                        int tpu, int dp, int kc, int rkc, int grid, int smem) {
  const long long ngroups = (n + GROUP - 1) / GROUP;
  if (nq < 1 || d < 1 || t < 1 || t > ngroups || ngroups > INT32_MAX || bq < 1 || gps < 1 ||
      tpu < 1 || grid < 1 || smem < 0 || (size_t)smem < merged_select_smem(t) ||
      (t > SEL_BIG_T_MAX && sort_g == nullptr))
    return false;
  a.q = q;
  a.norms = static_cast<const float*>(norms);
  a.x = x;
  a.mins = static_cast<float*>(mins);
  a.cand = static_cast<int*>(cand);
  a.thr = static_cast<float*>(thr);
  a.scores = static_cast<float*>(scores);
  a.vals = static_cast<float*>(vals);
  a.sort_g = static_cast<uint64_t*>(sort_g);
  a.counters = static_cast<int*>(counters);
  a.nq = nq;
  a.n = n;
  a.d = d;
  a.t = t;
  a.ngroups = (int)ngroups;
  a.bq = bq;
  a.nqt = (nq + bq - 1) / bq;
  a.gps = gps;
  a.nslices = (int)((ngroups + gps - 1) / gps);
  a.tpu = tpu;
  a.units = (a.nqt + tpu - 1) / tpu;
  a.dp = dp;
  a.kc = kc;
  a.rkc = rkc;
  // every ticket an int: the items, and one more per block
  const long long slots = (long long)nq * t;
  const long long items = (long long)a.nslices * a.nqt + nq +
                          (route == ROUTE_CUDA ? slots * RESCORE_SPLIT : slots);
  return items + grid <= INT_MAX;
}

// ---- route 1: bf16 on tensor cores ----

// A bf16 rescore pair's threads: each half of a 256-thread block, behind
// named barrier 1 or 2.
struct HalfThreads {
  static constexpr unsigned COUNT = RESCORE_MMA_WARPS * 32;
  static __device__ __forceinline__ unsigned tid() { return threadIdx.x % COUNT; }
  static __device__ __forceinline__ unsigned count() { return COUNT; }
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + threadIdx.x / COUNT), "n"(COUNT) : "memory");
  }
};

template <int BQ, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2) merged_mma_kernel(const MergedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ MergedItem desc[2];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const size_t pair_smem = round16(rescore_mma_smem(a.dp, a.rkc));
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) desc[k & 1] = next_item<ROUTE_MMA>(a);
    __syncthreads();
    const MergedItem it = desc[k & 1];
    if (it.kind == ITEM_DONE) return;
    if (it.kind == ITEM_SWEEP) {
      const unsigned b = it.index;
      groupmin_mma_block<__nv_bfloat16, BQ, VEC, RESIDENT, QueryMajorMins>(
          q, nullptr, a.norms, nullptr, x, a.mins, a.nq, a.n, a.d, a.dp, a.kc, a.ngroups, a.nqt,
          a.gps, nullptr, [b] { return b; });
      publish(a.counters + 1 + it.unit, [] { __syncthreads(); });
    } else if (it.kind == ITEM_SELECT) {
      select_query<0>(a, it.index, smem);
      publish(a.counters + 1 + a.units + it.index, [] { __syncthreads(); });
    } else {
      // one pair on each half of the block, each behind its own named barrier
      const unsigned h = threadIdx.x / HalfThreads::COUNT;
      if ((int)h < it.count) {
        const int g = h == 0 ? it.g[0] : it.g[1];
        const long long slot = (long long)it.index + h;
        rescore_mma_block<VEC, HalfThreads>(q, a.norms, x, a.scores, a.n, a.d, a.dp, a.rkc, a.t,
                                            smem + h * pair_smem, [slot] { return slot; },
                                            [g](long long) { return g; });
      }
    }
  }
}

// Route 1's launch on query tiles of BQ (topk_merged_mma<BQ>.cu).
template <int BQ>
cudaError_t launch_mma_tile(const MergedArgs& a, int vec, bool resident, int grid, int smem,
                            cudaStream_t s) {
  const void* fn = nullptr;
  if (vec == 8) fn = resident ? (const void*)merged_mma_kernel<BQ, 8, true>
                              : (const void*)merged_mma_kernel<BQ, 8, false>;
  if (vec == 2) fn = resident ? (const void*)merged_mma_kernel<BQ, 2, true>
                              : (const void*)merged_mma_kernel<BQ, 2, false>;
  if (vec == 1) fn = resident ? (const void*)merged_mma_kernel<BQ, 1, true>
                              : (const void*)merged_mma_kernel<BQ, 1, false>;
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<MergedArgs*>(&a)};
  return cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args, smem, s);
}

}  // namespace
