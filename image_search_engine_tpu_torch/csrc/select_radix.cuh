// The radix select of csrc/select_topt.cu (the algorithm is described
// there), as device functions shared by its kernel (select_radix_kernel)
// and the merged search's select items (topk_merged.cu).
//
// Two template arguments let other kernels run the same code:
//   kBar       the barrier among the select's SEL_THREADS threads: 0, the
//              block's own (__syncthreads; the select is the whole block),
//              else named barrier kBar over threads 0 .. SEL_THREADS - 1
//              (a larger block whose other threads do something else)
//   kCoherent  (select_radix_block) the row was written in the same launch:
//              it is read through L2 (__ldcg), staged or not, never through
//              the read-only path (__ldg), which is right only across
//              launches
// The select kernel instantiates kBar = 0 and kCoherent = false, the code
// it had before these moved here.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_BINS = 256;  // one 8-bit digit per pass, one bin per thread
constexpr int SEL_MAX_T = 256;  // t ranked by counting (ops/topk.py SELECT_RANK_MAX_T)
constexpr int SEL_BIG_T_MAX = 4096;  // t sorted in shared memory (SELECT_SHARED_SORT_MAX_T)
constexpr int SEL_STAGE_MAX = 12288;  // row entries staged in shared memory (48 KB)
constexpr int SEL_CAND_MAX = 1024;  // entries the sample's threshold may let through
constexpr int SEL_MERGE_MAX = SEL_CAND_MAX;  // candidates the merging block stages (split * t)
constexpr int SEL_SAMPLE_MAX_STRIDE = 8;  // ops/topk.py _SELECT_SAMPLE_MAX_STRIDE
constexpr int SEL_RANK_MAX = 512;  // candidates ranked directly, without a radix threshold
constexpr int SEL_PASS_UNROLL = 4;  // entries a thread loads before it counts them in a pass
// the scratch's (pair, value) entries, after the staged slice rounded up to 16 bytes
constexpr size_t SEL_CAND_BYTES = (size_t)SEL_CAND_MAX * (sizeof(uint64_t) + sizeof(float)) + 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEL_MAX_DEVICES = 64;

static_assert(SEL_THREADS == SEL_BINS, "pick_bin gives each thread one bin");

// The select's barrier: the block's (kBar = 0) or named barrier kBar over
// SEL_THREADS threads.
template <int kBar>
__device__ __forceinline__ void sel_sync() {
  if constexpr (kBar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"n"(kBar), "n"(SEL_THREADS) : "memory");
  }
}

// sel_sync that also returns whether p held in any of the threads.
template <int kBar>
__device__ __forceinline__ bool sel_sync_or(bool p) {
  if constexpr (kBar == 0) {
    return __syncthreads_or(p) != 0;
  } else {
    uint32_t r;
    asm volatile(
        "{\n"
        ".reg .pred a, o;\n"
        "setp.ne.u32 a, %1, 0;\n"
        "bar.red.or.pred o, %2, %3, a;\n"
        "selp.u32 %0, 1, 0, o;\n"
        "}\n"
        : "=r"(r)
        : "r"((uint32_t)p), "n"(kBar), "n"(SEL_THREADS)
        : "memory");
    return r != 0;
  }
}

// A load of a row entry (or four): through the read-only path, or through
// L2 when the row was written in this launch.
template <bool kCoherent, typename V>
__device__ __forceinline__ V sel_load(const V* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}


// Order-preserving key of a float: unsigned order of keys is float order,
// -0.0 is +0.0, and every NaN sorts after +inf.
__device__ __forceinline__ uint32_t sel_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  if (v != v) u = 0x7fc00000u;
  return u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
}

// bits [0, hi] set; none for hi < 0
__device__ __forceinline__ uint32_t low_ones(int hi) {
  return hi < 0 ? 0u : (hi >= 31 ? FULL : (2u << hi) - 1u);
}

// the highest set bit, -1 for 0
__device__ __forceinline__ int top_bit(uint32_t x) { return x ? 31 - __clz(x) : -1; }

// An entry's (key, position) pair as one 64-bit word, in the same order.
__device__ __forceinline__ uint64_t pair_of(uint32_t key, uint32_t pos) {
  return ((uint64_t)key << 32) | pos;
}

struct SelectShared {
  uint32_t hist[2][SEL_BINS];  // this pass's counts, and the next pass's (cleared)
  uint32_t wsum[SEL_WARPS];
  uint32_t red[4][SEL_WARPS];
  uint32_t bin, cnt, rem;
  int ncand;
  int last;
  uint64_t ckp[SEL_MAX_T];  // the t selected entries: (key, position) pair, value
  float cv[SEL_MAX_T];
};

// One count per lane that matches; a warp whose matching lanes share one
// digit (the usual case in a pass's high digits) adds them with one atomic.
__device__ __forceinline__ void hist_add(uint32_t* hist, bool m, uint32_t digit, int lane) {
  const unsigned act = __ballot_sync(FULL, m);
  if (act == 0) return;
  const int first = __ffs(act) - 1;
  const uint32_t d0 = __shfl_sync(FULL, digit, first);
  if (__all_sync(FULL, !m || digit == d0)) {
    if (lane == first) atomicAdd(hist + d0, (uint32_t)__popc(act));
  } else if (m) {
    atomicAdd(hist + digit, 1u);
  }
}

// After a counting pass into hist: the bin that holds the rem-th smallest
// (1-based) of the counted entries. Sets cnt to that bin's count and rem to
// the rank left within it, and clears `next` for the following pass. Every
// thread of the block calls it; three barriers.
template <int kBar>
__device__ __forceinline__ uint32_t pick_bin(SelectShared& s, const uint32_t* hist,
                                             uint32_t* next, uint32_t& cnt, uint32_t& rem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  sel_sync<kBar>();  // the counts are complete
  const uint32_t h = hist[tid];
  next[tid] = 0u;
  uint32_t x = h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s.wsum[warp] = x;
  sel_sync<kBar>();
  uint32_t pre = 0;
  for (int w = 0; w < warp; ++w) pre += s.wsum[w];
  const uint32_t incl = pre + x;
  const uint32_t excl = incl - h;
  if (excl < rem && rem <= incl) {
    s.bin = (uint32_t)tid;
    s.cnt = h;
    s.rem = rem - excl;
  }
  sel_sync<kBar>();
  cnt = s.cnt;
  rem = s.rem;
  return s.bin;
}

// Entry i of a row view (positions implicit): value v[i * stride], key
// sel_key of it, position pos0 + i * stride. kCoherent: the row lies in
// global memory and was written in this launch, so it is read through L2
// (__ldcg), never through the non-coherent L1 or read-only path.
template <bool kCoherent>
struct RowViewOf {
  const float* v;
  int pos0;
  int stride;
  int n;
  __device__ __forceinline__ float at(uint32_t j) const {
    if constexpr (kCoherent) {
      return __ldcg(v + j);
    } else {
      return v[j];
    }
  }
  __device__ __forceinline__ float val(int i) const {
    if constexpr (kCoherent) {
      return __ldcg(v + (size_t)i * stride);
    } else {
      return v[(size_t)i * stride];
    }
  }
  __device__ __forceinline__ uint32_t key(int i) const { return sel_key(val(i)); }
  __device__ __forceinline__ uint32_t pos(int i) const { return (uint32_t)(pos0 + i * stride); }
};
using RowView = RowViewOf<false>;

template <class View>
struct IsRowView : std::false_type {};
template <bool kCoherent>
struct IsRowView<RowViewOf<kCoherent>> : std::true_type {};

// Entry i of staged candidates: value v[i], (key, position) pair kp[i].
struct CandView {
  const float* v;
  const uint64_t* kp;
  int n;
  __device__ __forceinline__ float val(int i) const { return v[i]; }
  __device__ __forceinline__ uint32_t key(int i) const { return (uint32_t)(kp[i] >> 32); }
  __device__ __forceinline__ uint32_t pos(int i) const { return (uint32_t)kp[i]; }
};

// The view's t-th smallest (key, position) pair: exactly t entries are at
// or below it. Positions distinct and non-negative; 0 < t <= n. Every
// thread of the block calls it.
template <int kBar, class View>
__device__ uint64_t radix_threshold(const View& e, int t, SelectShared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = e.n;

  // 1. the range of the keys (and of the positions), so the digits start
  // below the bits every entry shares
  uint32_t kmin = FULL, kmax = 0u, pmin = FULL, pmax = 0u;
  for (int i = tid; i < n; i += SEL_THREADS) {
    const uint32_t k = e.key(i);
    const uint32_t pp = e.pos(i);
    kmin = min(kmin, k);
    kmax = max(kmax, k);
    pmin = min(pmin, pp);
    pmax = max(pmax, pp);
  }
  kmin = __reduce_min_sync(FULL, kmin);
  kmax = __reduce_max_sync(FULL, kmax);
  pmin = __reduce_min_sync(FULL, pmin);
  pmax = __reduce_max_sync(FULL, pmax);
  if (lane == 0) {
    s.red[0][warp] = kmin;
    s.red[1][warp] = kmax;
    s.red[2][warp] = pmin;
    s.red[3][warp] = pmax;
  }
  s.hist[0][tid] = 0u;
  s.hist[1][tid] = 0u;
  sel_sync<kBar>();
#pragma unroll
  for (int w = 0; w < SEL_WARPS; ++w) {
    kmin = min(kmin, s.red[0][w]);
    kmax = max(kmax, s.red[1][w]);
    pmin = min(pmin, s.red[2][w]);
    pmax = max(pmax, s.red[3][w]);
  }

  // 2. the key of the t-th entry, digit by digit; cnt entries share the
  // resolved prefix, and the rem-th smallest of them is the t-th overall
  int hi = top_bit(kmin ^ kmax);
  uint32_t prefix = kmin & ~low_ones(hi);
  uint32_t cnt = (uint32_t)n;
  uint32_t rem = (uint32_t)t;
  int buf = 0;
  while (cnt != rem && hi >= 0) {
    const int lo = max(hi - 7, 0);
    const uint32_t above = ~low_ones(hi);
    const uint32_t dmask = low_ones(hi - lo);
    uint32_t* h = s.hist[buf];
    for (int i0 = 0; i0 < n; i0 += SEL_THREADS * SEL_PASS_UNROLL) {
      uint32_t k[SEL_PASS_UNROLL];
#pragma unroll
      for (int u = 0; u < SEL_PASS_UNROLL; ++u) {  // the loads first, then the counts
        const int i = i0 + u * SEL_THREADS + tid;
        k[u] = i < n ? e.key(i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < SEL_PASS_UNROLL; ++u) {
        const bool m = i0 + u * SEL_THREADS + tid < n && (k[u] & above) == prefix;
        hist_add(h, m, (k[u] >> lo) & dmask, lane);
      }
    }
    prefix |= pick_bin<kBar>(s, h, s.hist[buf ^ 1], cnt, rem) << lo;
    hi = lo - 1;
    buf ^= 1;
  }
  if (cnt == rem) return pair_of(prefix | low_ones(hi), FULL);  // the whole bin is wanted

  // 3. the t-th key is tied: its position, digit by digit, among the tied
  int phi = top_bit(pmin ^ pmax);
  uint32_t pprefix = pmin & ~low_ones(phi);
  while (cnt != rem && phi >= 0) {
    const int lo = max(phi - 7, 0);
    const uint32_t above = ~low_ones(phi);
    const uint32_t dmask = low_ones(phi - lo);
    uint32_t* h = s.hist[buf];
    for (int i0 = 0; i0 < n; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      uint32_t pp = 0u;
      bool m = false;
      if (i < n) {
        pp = e.pos(i);
        m = e.key(i) == prefix && (pp & above) == pprefix;
      }
      hist_add(h, m, (pp >> lo) & dmask, lane);
    }
    pprefix |= pick_bin<kBar>(s, h, s.hist[buf ^ 1], cnt, rem) << lo;
    phi = lo - 1;
    buf ^= 1;
  }
  return pair_of(prefix, pprefix | low_ones(phi));
}

// Compacts the view's entries at or below the pair thr (warp-aggregated
// slots, in no particular order): slot j < cap gets value ov[j] and pair
// okp[j]. Returns how many entries are at or below thr, to every thread
// (the slots past cap are dropped). Every thread of the block calls it.
template <int kBar, class View>
__device__ int compact(const View& e, uint64_t thr, float* ov, uint64_t* okp, int cap,
                       SelectShared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s.ncand = 0;
  sel_sync<kBar>();
  for (int i0 = 0; i0 < e.n; i0 += SEL_THREADS) {
    const int i = i0 + tid;
    float v = 0.f;
    uint64_t kp = 0u;
    bool sel = false;
    if (i < e.n) {
      v = e.val(i);
      kp = pair_of(e.key(i), e.pos(i));
      sel = kp <= thr;
    }
    const unsigned b = __ballot_sync(FULL, sel);
    if (b == 0u) continue;  // warp-uniform
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.ncand, __popc(b));
    base = __shfl_sync(FULL, base, 0);
    const int slot = base + __popc(b & ((1u << lane) - 1u));
    if (sel && slot < cap) {
      ov[slot] = v;
      okp[slot] = kp;
    }
  }
  sel_sync<kBar>();
  const int c = s.ncand;
  sel_sync<kBar>();  // every thread has read it before it is reset
  return c;
}

// The sample stride for t of n entries (ops/topk.py select_sample_stride): 1
// (no sample) unless a sample of every stride-th entry holds at least 2t
// entries and its threshold lets about stride * t <= SEL_CAND_MAX / 2
// entries through.
__device__ __forceinline__ int sample_stride(int n, int t) {
  const int st = min(SEL_SAMPLE_MAX_STRIDE, SEL_CAND_MAX / (2 * t));
  return (st >= 2 && n / st >= 2 * t) ? st : 1;
}

// The t smallest of c entries (pair kp[i], value v[i]) in ascending order
// to out_v / out_i: each entry's rank is the number of pairs below it, c
// broadcast reads of shared memory for each of a thread's entries. One
// barrier.
template <int kBar>
__device__ void rank_select(const uint64_t* kp, const float* v, int c, int t, float* out_v,
                            int* out_i) {
  for (int i = threadIdx.x; i < c; i += SEL_THREADS) {
    const uint64_t ki = kp[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < c; ++j) r += kp[j] < ki ? 1 : 0;
    if (r < t) {
      out_v[r] = v[i];
      out_i[r] = (int)(uint32_t)ki;
    }
  }
  sel_sync<kBar>();
}

// The smallest power of two at or above t (t >= 1).
__device__ __forceinline__ int pow2_at_least(int t) { return t <= 1 ? 1 : 1 << (32 - __clz(t - 1)); }

// Where the sort of t > SEL_MAX_T selected entries works: for t up to
// SEL_BIG_T_MAX, pow2_at_least(t) (pair, value) entries of dynamic shared
// memory (kp, v); beyond, SEL_WARPS x SEL_BINS digit counts of it (wcnt) and
// 2t pairs of a global scratch for this row (g).
struct SortScratch {
  uint64_t* kp;
  float* v;
  int* wcnt;
  uint64_t* g;
};

// Sorts p (a power of two, >= 64) (pair, value) entries of shared memory
// by pair, ascending: a bitonic network, each stage's p / 2
// compare-exchanges spread over the block, log p (log p + 1) / 2 stages.
// Thread i of the block takes pairs i, i + SEL_THREADS, ..., so a stage of
// stride j <= 32 keeps each warp within its own 64 entries: between two such
// stages a warp waits only for itself, and a block-wide barrier separates
// the others.
template <int kBar>
__device__ void bitonic_sort(uint64_t* kp, float* v, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += SEL_THREADS) {
        const int lo = 2 * i - (i & (j - 1));  // (i / j) * 2j + i % j
        const int hi = lo + j;
        const uint64_t a = kp[lo];
        const uint64_t c = kp[hi];
        if ((a > c) == ((lo & k) == 0)) {
          kp[lo] = c;
          kp[hi] = a;
          const float tv = v[lo];
          v[lo] = v[hi];
          v[hi] = tv;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the next stage's stride (k: the next k's first)
      if (j <= 32 && next <= 32 && !(j == 1 && k == p)) {
        __syncwarp();
      } else {
        sel_sync<kBar>();
      }
    }
  }
}

// Exclusive scan of the SEL_BINS counts hist[tid] into base[tid]; returns to
// every thread whether one bin holds all `total` counts. Three barriers.
template <int kBar>
__device__ __forceinline__ bool scan_bins(SelectShared& s, const uint32_t* hist, uint32_t* base,
                                          int total) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  sel_sync<kBar>();  // the counts are complete
  const uint32_t h = hist[tid];
  uint32_t x = h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s.wsum[warp] = x;
  sel_sync<kBar>();
  uint32_t pre = 0;
  for (int w = 0; w < warp; ++w) pre += s.wsum[w];
  base[tid] = pre + x - h;
  return sel_sync_or<kBar>(h == (uint32_t)total);
}

// The t entries of the row view e (stride 1) at or below the pair thr, in
// ascending (key, position) order to out_v / out_i, for t beyond
// SEL_BIG_T_MAX. The entries are compacted in position order (a block-wide
// scan of each 256 entries' votes) into ss.g, then sorted by a stable LSD
// radix sort over the key's 8-bit digits between ss.g and ss.g + t (a pass
// is skipped where every key has the same digit): a histogram, its scan,
// then each 256 entries in order, each going to its digit's next place
// after the entries before it (its rank among its warp's lanes of that
// digit, __match_any_sync, plus the counts of the warps before it). Equal
// keys keep position order. Values are read back from the row by position.
// Every thread of the block calls it; ends with a barrier.
template <int kBar, class Row>
__device__ void global_sort(const Row& e, uint64_t thr, int t, float* out_v, int* out_i,
                            SelectShared& s, const SortScratch& ss) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint64_t* src = ss.g;
  uint64_t* dst = ss.g + t;
  int filled = 0;
  for (int i0 = 0; i0 < e.n; i0 += SEL_THREADS) {
    const int i = i0 + tid;
    uint64_t kp = 0u;
    bool sel = false;
    if (i < e.n) {
      kp = pair_of(e.key(i), e.pos(i));
      sel = kp <= thr;
    }
    const unsigned vote = __ballot_sync(FULL, sel);
    if (lane == 0) s.wsum[warp] = (uint32_t)__popc(vote);
    sel_sync<kBar>();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < SEL_WARPS; ++w) {
      const int c = (int)s.wsum[w];
      before += w < warp ? c : 0;
      all += c;
    }
    if (sel) src[filled + before + __popc(vote & below)] = kp;
    filled += all;
    sel_sync<kBar>();  // every thread has read the votes before the next tile's
  }
  for (int j = tid; j < SEL_WARPS * SEL_BINS; j += SEL_THREADS) ss.wcnt[j] = 0;
  uint32_t* hist = s.hist[0];
  uint32_t* base = s.hist[1];
  for (int shift = 32; shift < 64; shift += 8) {
    hist[tid] = 0u;
    sel_sync<kBar>();
    for (int i = tid; i < t; i += SEL_THREADS) atomicAdd(hist + ((src[i] >> shift) & 0xffu), 1u);
    if (scan_bins<kBar>(s, hist, base, t)) continue;  // one digit: the order stays
    for (int i0 = 0; i0 < t; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      const bool valid = i < t;
      const uint64_t kp = valid ? src[i] : 0u;
      const int dig = valid ? (int)((kp >> shift) & 0xffu) : SEL_BINS;
      const unsigned peers = __match_any_sync(FULL, dig);
      const bool leader = (peers & below) == 0u;
      if (valid && leader) ss.wcnt[warp * SEL_BINS + dig] = __popc(peers);
      sel_sync<kBar>();  // the tile's counts, and the bases after the tiles before it
      if (valid) {
        int at = (int)base[dig] + __popc(peers & below);
        for (int w = 0; w < warp; ++w) at += ss.wcnt[w * SEL_BINS + dig];
        dst[at] = kp;
      }
      sel_sync<kBar>();  // every thread has read the counts and bases
      if (valid && leader) {
        atomicAdd(base + dig, (uint32_t)__popc(peers));
        ss.wcnt[warp * SEL_BINS + dig] = 0;
      }
      __syncwarp();  // this warp's counts are cleared before its next tile sets them
    }
    uint64_t* tmp = src;
    src = dst;
    dst = tmp;
    sel_sync<kBar>();  // the pass's writes are visible to the next pass
  }
  for (int i = tid; i < t; i += SEL_THREADS) {
    const uint32_t pos = (uint32_t)src[i];
    out_i[i] = (int)pos;
    out_v[i] = e.at(pos - (uint32_t)e.pos0);
  }
  sel_sync<kBar>();
}

// The entries of the view e at or below the pair thr (exactly t of them) to
// out_v / out_i, in no particular order (a split row's slice: the merge
// selects from all slices' candidates). Ends with a barrier.
template <int kBar, class View>
__device__ void emit_unsorted(const View& e, uint64_t thr, float* out_v, int* out_i,
                              SelectShared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s.ncand = 0;
  sel_sync<kBar>();
  for (int i0 = 0; i0 < e.n; i0 += SEL_THREADS) {
    const int i = i0 + tid;
    bool sel = false;
    if (i < e.n) sel = pair_of(e.key(i), e.pos(i)) <= thr;
    const unsigned b = __ballot_sync(FULL, sel);
    if (b == 0u) continue;  // warp-uniform
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.ncand, __popc(b));
    base = __shfl_sync(FULL, base, 0);
    if (sel) {
      const int slot = base + __popc(b & ((1u << lane) - 1u));
      out_v[slot] = e.val(i);
      out_i[slot] = (int)e.pos(i);
    }
  }
  sel_sync<kBar>();
}

// The t entries of the view e at or below the pair thr (exactly t of them)
// in ascending (key, position) order to out_v / out_i: up to SEL_MAX_T
// compacted into SelectShared and ranked by counting; up to SEL_BIG_T_MAX
// compacted into ss.kp / ss.v, padded with the largest pair to a power of
// two and sorted by a bitonic network; beyond (a whole row's view only: the
// merges take t <= SEL_MERGE_MAX), global_sort. Ends with a barrier.
template <int kBar, class View>
__device__ void sort_selected(const View& e, uint64_t thr, int t, float* out_v, int* out_i,
                              SelectShared& s, const SortScratch& ss) {
  if (t <= SEL_MAX_T) {
    compact<kBar>(e, thr, s.cv, s.ckp, SEL_MAX_T, s);
    rank_select<kBar>(s.ckp, s.cv, t, t, out_v, out_i);
    return;
  }
  if (t <= SEL_BIG_T_MAX) {
    const int p = pow2_at_least(t);
    compact<kBar>(e, thr, ss.v, ss.kp, t, s);
    for (int i = t + threadIdx.x; i < p; i += SEL_THREADS) ss.kp[i] = ~0ull;
    sel_sync<kBar>();
    bitonic_sort<kBar>(ss.kp, ss.v, p);
    for (int i = threadIdx.x; i < t; i += SEL_THREADS) {
      out_v[i] = ss.v[i];
      out_i[i] = (int)(uint32_t)ss.kp[i];
    }
    sel_sync<kBar>();
    return;
  }
  if constexpr (IsRowView<View>::value) global_sort<kBar>(e, thr, t, out_v, out_i, s, ss);
}

// The t smallest of c staged candidates to out_v / out_i in ascending
// order: ranked directly up to SEL_RANK_MAX of them, else the radix
// threshold first and the t at or below it sorted.
template <int kBar>
__device__ void select_candidates(const float* cv, const uint64_t* ckp, int c, int t,
                                  float* out_v, int* out_i, SelectShared& s,
                                  const SortScratch& ss) {
  if (c <= SEL_RANK_MAX) {
    rank_select<kBar>(ckp, cv, c, t, out_v, out_i);
    return;
  }
  const CandView cands{cv, ckp, c};
  sort_selected<kBar>(cands, radix_threshold<kBar>(cands, t, s), t, out_v, out_i, s, ss);
}

// The t smallest (key, position) entries of a row's n entries (the view
// e, stride 1) to out_v / out_i in ascending order, 0 < t <= n; cand_v /
// cand_kp: SEL_CAND_MAX entries of shared scratch. Up to SEL_RANK_MAX
// entries are ranked directly. Beyond, for t small enough to sample (t <=
// SEL_CAND_MAX / 4), the t-th pair of a sample of every stride-th entry is
// at or above the row's t-th pair (a subset's t-th smallest is no smaller),
// so the entries at or below it, about stride * t of them, hold the t
// wanted: the select runs over those alone, or over the whole row if they
// overflow the scratch or the row is too small to sample, as it does for
// every larger t. Ends with a barrier.
template <int kBar, class Row>
__device__ void block_select(const Row& e, int t, float* cand_v, uint64_t* cand_kp,
                             float* out_v, int* out_i, SelectShared& s, const SortScratch& ss,
                             bool sorted = true) {
  const int st = sample_stride(e.n, t);
  if (e.n <= SEL_RANK_MAX || st > 1) {
    const uint64_t cut =
        e.n <= SEL_RANK_MAX
            ? ~0ull
            : radix_threshold<kBar>(Row{e.v, e.pos0, st, (e.n + st - 1) / st}, t, s);
    const int c = compact<kBar>(e, cut, cand_v, cand_kp, SEL_CAND_MAX, s);
    if (c <= SEL_CAND_MAX) {
      select_candidates<kBar>(cand_v, cand_kp, c, t, out_v, out_i, s, ss);
      return;
    }
  }
  const uint64_t thr = radix_threshold<kBar>(e, t, s);
  if (sorted || t <= SEL_MAX_T) {
    sort_selected<kBar>(e, thr, t, out_v, out_i, s, ss);
  } else {
    emit_unsorted<kBar>(e, thr, out_v, out_i, s);
  }
}

// Bytes of dynamic shared memory the sort of t selected entries takes
// after the scratch (SortScratch): none up to SEL_MAX_T.
__host__ __device__ __forceinline__ size_t sort_bytes(int t) {
  if (t <= SEL_MAX_T) return 0;
  if (t <= SEL_BIG_T_MAX) {
    size_t p = 1;
    while (p < (size_t)t) p <<= 1;
    return p * (sizeof(uint64_t) + sizeof(float));
  }
  return (size_t)SEL_WARPS * SEL_BINS * sizeof(int);
}

// Block b takes slice b % split of row b / split: entries [part * slice,
// part * slice + slice) of the row. With split == 1 it writes the row's t
// best to vals / ids; otherwise its slice's min(t, n) best to part_v /
// part_i[b * t ...], and the row's last block to finish merges the row's
// candidates ((split - 1) * t + min(t, last slice), contiguous) into vals /
// ids and resets the row's ticket counter. Dynamic shared memory: the
// staged slice (kStaged), then SEL_CAND_MAX (value, pair) entries of
// scratch, then sort_bytes(t). For t beyond SEL_BIG_T_MAX (split == 1),
// sort_g holds 2t pairs of global scratch per row. b: the block's work item
// (the kernel's blockIdx.x); s: the select's shared state. kSplit false
// compiles the split == 1 path alone (a caller that never splits a row).
template <bool kStaged, bool kCoherent, int kBar, bool kSplit = true>
__device__ __forceinline__ void select_radix_block(const float* mins, float* vals, int* ids,
                                                   float* part_v, int* part_i, unsigned* counters,
                                                   uint64_t* sort_g, int w, int t, int split,
                                                   int slice, int b, unsigned char* dyn,
                                                   SelectShared& s) {
  const int q = b / split;
  const int part = b - q * split;
  const int lo = part * slice;
  const int n = min(w - lo, slice);
  const float* row = mins + (size_t)q * w + lo;
  const float* src = row;
  unsigned char* scratch = dyn;
  if constexpr (kStaged) {  // 16-byte loads from the row's first 16-byte boundary on
    float* srow = reinterpret_cast<float*>(dyn);
    const int head = min(n, (int)(((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) / 4));
    const int nv = (n - head) / 4;
    if ((int)threadIdx.x < head) srow[threadIdx.x] = sel_load<kCoherent>(row + threadIdx.x);
    const float4* rv = reinterpret_cast<const float4*>(row + head);
#pragma unroll 4
    for (int j = threadIdx.x; j < nv; j += SEL_THREADS) {
      const float4 x = sel_load<kCoherent>(rv + j);
      float* d = srow + head + 4 * j;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
    for (int i = head + 4 * nv + threadIdx.x; i < n; i += SEL_THREADS)
      srow[i] = sel_load<kCoherent>(row + i);
    sel_sync<kBar>();
    src = srow;
    scratch = dyn + (((size_t)slice * sizeof(float) + 15) & ~(size_t)15);
  }
  uint64_t* cand_kp = reinterpret_cast<uint64_t*>(scratch);
  float* cand_v = reinterpret_cast<float*>(cand_kp + SEL_CAND_MAX);
  uint64_t* sort_kp = reinterpret_cast<uint64_t*>(cand_v + SEL_CAND_MAX);
  const SortScratch ss{sort_kp,
                       reinterpret_cast<float*>(sort_kp + (t <= SEL_BIG_T_MAX ? pow2_at_least(t)
                                                                              : 0)),
                       reinterpret_cast<int*>(sort_kp),
                       sort_g != nullptr ? sort_g + (size_t)q * 2 * t : nullptr};
  float* out_v = vals + (size_t)q * t;
  int* out_i = ids + (size_t)q * t;
  const RowViewOf<kCoherent && !kStaged> rowv{src, lo, 1, n};
  if (!kSplit || split == 1) {
    block_select<kBar>(rowv, t, cand_v, cand_kp, out_v, out_i, s, ss);
    return;
  }
  block_select<kBar>(rowv, min(t, n), cand_v, cand_kp, part_v + (size_t)b * t,
                     part_i + (size_t)b * t, s, ss, false);
  __threadfence();  // this block's candidates reach L2 before its ticket
  sel_sync<kBar>();
  if (threadIdx.x == 0) s.last = atomicAdd(counters + q, 1u) == (unsigned)(split - 1);
  sel_sync<kBar>();
  if (!s.last) return;
  const int c = (split - 1) * t + min(t, w - (split - 1) * slice);
  const size_t base = (size_t)q * split * t;
  for (int i = threadIdx.x; i < c; i += SEL_THREADS) {  // from L2: written in this launch
    const float v = __ldcg(part_v + base + i);
    cand_v[i] = v;
    cand_kp[i] = pair_of(sel_key(v), (uint32_t)__ldcg(part_i + base + i));
  }
  sel_sync<kBar>();
  select_candidates<kBar>(cand_v, cand_kp, c, t, out_v, out_i, s, ss);
  if (threadIdx.x == 0) counters[q] = 0u;
}

}  // namespace
