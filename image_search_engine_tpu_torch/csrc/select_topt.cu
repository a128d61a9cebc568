// The candidate select for Hopper (sm_90a), with a plain C interface for
// ctypes (ops/_kernels.py builds this file with nvcc and binds it; ops/topk.py
// holds the wrapper, its plan and the plain PyTorch version).
//
//   select_radix_kernel  per row of a contiguous f32 (Q, W) array, the t
//                        smallest entries in ascending (value, position)
//                        order, ties to the lowest position. Replaces
//                        image_search_engine_tpu/ops/topk_pallas.py
//                        _select_topt_kernel for t <= SEL_MAX_T; larger t
//                        take the extract-min kernel (topk_twophase.cu
//                        select_kernel, t passes), a route the wrapper
//                        chooses on t.
//
// Bound: the row is read once, Q * W * 4 bytes (128 MB at the bench point,
// 0.038 ms at 3.35 TB/s), and the output written once. The extract-min
// kernel makes t serial passes over the row, each with two block-wide
// reductions, so it is bound by the latency of those passes. This kernel
// reads the row once, into shared memory (rows of up to SEL_STAGE_MAX
// entries; wider ones are re-read through L1/L2), and finds the t-th
// smallest (key, position) pair by a radix select: 8-bit digits of an
// order-preserving 32-bit key, most significant first, one shared-memory
// histogram and three barriers per digit, starting below the bits that the
// entries' smallest and largest keys share. When the bin that holds the
// t-th entry holds exactly the entries still wanted, the select stops; when
// the key is resolved and the t-th key is tied, it goes on over the bits of
// the positions among the tied entries, so ties go to the lowest position.
// The entries at or below the found pair (exactly t of them) are compacted,
// and only those are sorted, each by counting the pairs below it. The
// number of barriers is bounded by the digits of the key and the position,
// not by t.
//
// A digit pass costs a few dozen instructions an entry (the key, votes,
// shared-memory atomics), so the passes run over few entries: first over a
// sample, every stride-th entry of the row, whose t-th pair is at or above
// the row's (a subset's t-th smallest is no smaller); one pass over the row
// compacts the entries at or below it, about stride * t of them; up to
// SEL_RANK_MAX of them are then ranked directly by counting, more go
// through the digit passes first. Should they overflow the scratch (rows
// whose smallest entries avoid the sampled positions), the select runs over
// the whole row.
//
// The key: the float's bits, sign-flipped so that unsigned order is float
// order, with -0.0 folded onto +0.0 (they compare equal, so they order by
// position, as the stable sort and the extract-min kernel order them) and
// every NaN onto one key above +inf; each output value keeps its own bits.
//
// Rows of a few queries are split over `split` blocks (ops/topk.py
// select_plan), so that more SMs read them: each block selects the t best
// of its slice, unsorted, into scratch, and the last block of the row to
// finish (a ticket counter per row, reset by that block) selects the t best
// of those candidates with their positions. The lexicographic key makes
// that merge exact.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_BINS = 256;  // one 8-bit digit per pass, one bin per thread
constexpr int SEL_MAX_T = 256;  // ops/topk.py SELECT_RADIX_MAX_T
constexpr int SEL_STAGE_MAX = 12288;  // row entries staged in shared memory (48 KB)
constexpr int SEL_CAND_MAX = 1024;  // entries the sample's threshold may let through
constexpr int SEL_MERGE_MAX = SEL_CAND_MAX;  // candidates the merging block stages (split * t)
constexpr int SEL_SAMPLE_MAX_STRIDE = 8;  // ops/topk.py _SELECT_SAMPLE_MAX_STRIDE
constexpr int SEL_RANK_MAX = 512;  // candidates ranked directly, without a radix threshold
// the scratch's (pair, value) entries, after the staged slice rounded up to 16 bytes
constexpr size_t SEL_CAND_BYTES = (size_t)SEL_CAND_MAX * (sizeof(uint64_t) + sizeof(float)) + 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEL_MAX_DEVICES = 64;

static_assert(SEL_THREADS == SEL_BINS, "pick_bin gives each thread one bin");

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
__device__ __forceinline__ uint32_t pick_bin(SelectShared& s, const uint32_t* hist,
                                             uint32_t* next, uint32_t& cnt, uint32_t& rem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();  // the counts are complete
  const uint32_t h = hist[tid];
  next[tid] = 0u;
  uint32_t x = h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s.wsum[warp] = x;
  __syncthreads();
  uint32_t pre = 0;
  for (int w = 0; w < warp; ++w) pre += s.wsum[w];
  const uint32_t incl = pre + x;
  const uint32_t excl = incl - h;
  if (excl < rem && rem <= incl) {
    s.bin = (uint32_t)tid;
    s.cnt = h;
    s.rem = rem - excl;
  }
  __syncthreads();
  cnt = s.cnt;
  rem = s.rem;
  return s.bin;
}

// Entry i of a row view (positions implicit): value v[i * stride], key
// sel_key of it, position pos0 + i * stride.
struct RowView {
  const float* v;
  int pos0;
  int stride;
  int n;
  __device__ __forceinline__ float val(int i) const { return v[(size_t)i * stride]; }
  __device__ __forceinline__ uint32_t key(int i) const { return sel_key(val(i)); }
  __device__ __forceinline__ uint32_t pos(int i) const { return (uint32_t)(pos0 + i * stride); }
};

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
template <class View>
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
  __syncthreads();
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
    for (int i0 = 0; i0 < n; i0 += SEL_THREADS) {
      const int i = i0 + tid;
      uint32_t k = 0u;
      bool m = false;
      if (i < n) {
        k = e.key(i);
        m = (k & above) == prefix;
      }
      hist_add(h, m, (k >> lo) & dmask, lane);
    }
    prefix |= pick_bin(s, h, s.hist[buf ^ 1], cnt, rem) << lo;
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
    pprefix |= pick_bin(s, h, s.hist[buf ^ 1], cnt, rem) << lo;
    phi = lo - 1;
    buf ^= 1;
  }
  return pair_of(prefix, pprefix | low_ones(phi));
}

// Compacts the view's entries at or below the pair thr (warp-aggregated
// slots, in no particular order): slot j < cap gets value ov[j] and pair
// okp[j]. Returns how many entries are at or below thr, to every thread
// (the slots past cap are dropped). Every thread of the block calls it.
template <class View>
__device__ int compact(const View& e, uint64_t thr, float* ov, uint64_t* okp, int cap,
                       SelectShared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s.ncand = 0;
  __syncthreads();
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
  __syncthreads();
  const int c = s.ncand;
  __syncthreads();  // every thread has read it before it is reset
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
  __syncthreads();
}

// The t smallest of c staged candidates to out_v / out_i in ascending
// order: ranked directly up to SEL_RANK_MAX of them, else the radix
// threshold first and the t at or below it ranked.
__device__ void select_candidates(const float* cv, const uint64_t* ckp, int c, int t,
                                  float* out_v, int* out_i, SelectShared& s) {
  if (c <= SEL_RANK_MAX) {
    rank_select(ckp, cv, c, t, out_v, out_i);
    return;
  }
  const CandView cands{cv, ckp, c};
  compact(cands, radix_threshold(cands, t, s), s.cv, s.ckp, SEL_MAX_T, s);
  rank_select(s.ckp, s.cv, t, t, out_v, out_i);
}

// The t smallest (key, position) entries of a row's n entries (the view
// e) to out_v / out_i in ascending order. 0 < t <= min(n, SEL_MAX_T);
// cand_v / cand_kp: SEL_CAND_MAX entries of shared scratch. Up to
// SEL_RANK_MAX entries are ranked directly. Beyond, the t-th pair of a
// sample of every stride-th entry is at or above the row's t-th pair (a
// subset's t-th smallest is no smaller), so the entries at or below it,
// about stride * t of them, hold the t wanted: the select runs over those
// alone, or over the whole row if they overflow the scratch or the row is
// too small to sample. Ends with a barrier.
__device__ void block_select(const RowView& e, int t, float* cand_v, uint64_t* cand_kp,
                             float* out_v, int* out_i, SelectShared& s) {
  const int st = sample_stride(e.n, t);
  if (e.n <= SEL_RANK_MAX || st > 1) {
    const uint64_t cut =
        e.n <= SEL_RANK_MAX
            ? ~0ull
            : radix_threshold(RowView{e.v, e.pos0, st, (e.n + st - 1) / st}, t, s);
    const int c = compact(e, cut, cand_v, cand_kp, SEL_CAND_MAX, s);
    if (c <= SEL_CAND_MAX) {
      select_candidates(cand_v, cand_kp, c, t, out_v, out_i, s);
      return;
    }
  }
  compact(e, radix_threshold(e, t, s), s.cv, s.ckp, SEL_MAX_T, s);
  rank_select(s.ckp, s.cv, t, t, out_v, out_i);
}

// Block b takes slice b % split of row b / split: entries [part * slice,
// part * slice + slice) of the row. With split == 1 it writes the row's t
// best to vals / ids; otherwise its slice's min(t, n) best to part_v /
// part_i[b * t ...], and the row's last block to finish merges the row's
// candidates ((split - 1) * t + min(t, last slice), contiguous) into vals /
// ids and resets the row's ticket counter. Dynamic shared memory: the
// staged slice (kStaged), then SEL_CAND_MAX (value, pair) entries of
// scratch.
template <bool kStaged>
__global__ void __launch_bounds__(SEL_THREADS)
    select_radix_kernel(const float* __restrict__ mins, float* __restrict__ vals,
                        int* __restrict__ ids, float* part_v, int* part_i,
                        unsigned* counters, int w, int t, int split, int slice) {
  __shared__ SelectShared s;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int b = blockIdx.x;
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
    if ((int)threadIdx.x < head) srow[threadIdx.x] = __ldg(row + threadIdx.x);
    const float4* rv = reinterpret_cast<const float4*>(row + head);
#pragma unroll 4
    for (int j = threadIdx.x; j < nv; j += SEL_THREADS) {
      const float4 x = __ldg(rv + j);
      float* d = srow + head + 4 * j;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
    for (int i = head + 4 * nv + threadIdx.x; i < n; i += SEL_THREADS) srow[i] = __ldg(row + i);
    __syncthreads();
    src = srow;
    scratch = dyn + (((size_t)slice * sizeof(float) + 15) & ~(size_t)15);
  }
  uint64_t* cand_kp = reinterpret_cast<uint64_t*>(scratch);
  float* cand_v = reinterpret_cast<float*>(cand_kp + SEL_CAND_MAX);
  float* out_v = vals + (size_t)q * t;
  int* out_i = ids + (size_t)q * t;
  const RowView rowv{src, lo, 1, n};
  if (split == 1) {
    block_select(rowv, t, cand_v, cand_kp, out_v, out_i, s);
    return;
  }
  block_select(rowv, min(t, n), cand_v, cand_kp, part_v + (size_t)b * t, part_i + (size_t)b * t,
               s);
  __threadfence();  // this block's candidates reach L2 before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s.last = atomicAdd(counters + q, 1u) == (unsigned)(split - 1);
  __syncthreads();
  if (!s.last) return;
  const int c = (split - 1) * t + min(t, w - (split - 1) * slice);
  const size_t base = (size_t)q * split * t;
  for (int i = threadIdx.x; i < c; i += SEL_THREADS) {  // from L2: written in this launch
    const float v = __ldcg(part_v + base + i);
    cand_v[i] = v;
    cand_kp[i] = pair_of(sel_key(v), (uint32_t)__ldcg(part_i + base + i));
  }
  __syncthreads();
  select_candidates(cand_v, cand_kp, c, t, out_v, out_i, s);
  if (threadIdx.x == 0) counters[q] = 0u;
}

}  // namespace

extern "C" {

// mins (nq, w) f32 -> vals (nq, t) f32, ids (nq, t) int32, on the plan of
// ops/topk.py select_plan: split blocks per row of slice entries each
// (split * slice >= w, no empty slice), each staging its slice in shared
// memory when staged is 1 (slice <= SEL_STAGE_MAX); with split > 1, part_v
// / part_i hold nq * split * t entries and counters nq zeros (left zero).
// Returns the cudaError_t of the launch (0 = success).
int ise_select_radix(const void* mins, void* vals, void* ids, void* part_v, void* part_i,
                     void* counters, int nq, int w, int t, int split, int slice, int staged,
                     void* stream) {
  if (nq < 1 || t < 1 || t > SEL_MAX_T || t > w || split < 1 || slice < 1 ||
      (long long)split * slice < w || (long long)(split - 1) * slice >= w ||
      (staged != 0 && slice > SEL_STAGE_MAX))
    return cudaErrorInvalidValue;
  if (split > 1 && (slice < t || split * t > SEL_MERGE_MAX)) return cudaErrorInvalidValue;
  const long long grid = (long long)nq * split;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  staged = staged != 0 ? 1 : 0;
  // the staged slice, then the scratch, where the merge also stages its
  // split * t <= SEL_MERGE_MAX candidates
  const size_t smem = (staged ? (size_t)slice * sizeof(float) : 0) + SEL_CAND_BYTES;
  auto kernel = staged ? select_radix_kernel<true> : select_radix_kernel<false>;
  // the shared-memory limit, raised once per device and instantiation
  static bool configured[SEL_MAX_DEVICES][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= SEL_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!configured[dev][staged]) {
    const size_t most = (staged ? (size_t)SEL_STAGE_MAX * sizeof(float) : 0) + SEL_CAND_BYTES;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    configured[dev][staged] = true;
  }
  kernel<<<(unsigned)grid, SEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mins), static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(part_v), static_cast<int*>(part_i), static_cast<unsigned*>(counters),
      w, t, split, slice);
  return cudaGetLastError();
}

}  // extern "C"
