// IVF probed scan for Hopper (sm_90a), with a plain C interface for ctypes
// (ops/_kernels.py builds it; ops/ivf.py holds the wrapper, its plan and the
// plain PyTorch version). For each (query, probe slot), the scores
// norms[b, r] - 2 q.x[b, r] of every row r of the probed bucket b, read in
// place from the list-contiguous (nbuckets, cap, d) table. Replaces
// image_search_engine_tpu/ops/ivf_pallas.py _probed_scan_kernel, on two
// routes (ops/ivf.py probed_scan_plan): slot by slot, or, for batches whose
// slots share buckets, bucket by bucket.
//
//   probed_scan_row_kernel   the slot route over rows wider than 512 bytes
//                            (a d = 2048 embedding) or for one query: one
//                            warp a row, its loads in registers.
//   probed_scan_tile_kernel  the slot route over narrower rows (d = 128)
//                            beyond one query, and the bucket route: a
//                            block's slice of rows staged in shared memory.
//
// Bound: the bytes of the distinct probed buckets (cap * d * itemsize each),
// read as contiguous blocks; the flops (2 cap d per slot) are far below the
// card's f32 rate at d = 2048 and Q up to a few thousand. The TPU kernel
// padded cap and d to 128; here the ragged edges are masked and nothing is
// copied. Pad slots carry +inf norms and finite rows, so they score +inf
// (never NaN); a bucket id < 0 or >= nbuckets scores +inf.
//
// On the slot route a block serves one (query, probe) slot, so a bucket is
// read once per query that probes it (batched IVF at Q = 1024 over 1M x 128
// probes ~6.8 slots a bucket). On the bucket route the slots are first
// grouped by bucket (ops/topk.py group_order, the int8 rescore's one-block
// counting sort, which also leaves each bucket's range of the ordered slots
// and the list of buckets that have slots), and a block serves every slot
// that probes its bucket, so a bucket is read from device memory once per
// batch. Its blocks are one per listed bucket, as many as there can be
// (slots or bins, the fewer; on an H100 80GB HBM3 at 700 W, 220k empty
// blocks, a block per bin of 1383 x 159 slices, took 0.29 ms).
//
// Row kernel: at Q = 1 a handful of probes is all the work, and bytes in
// flight bound it. Each lane issues up to ROW_UNROLL 16-byte loads of its row
// (a 2048-wide bf16 row at once, kept as loaded until used) before the block
// copies the query into shared memory, so each warp multiplies as soon as
// its own row arrives (a staged tile, which waits for the whole tile, was
// ~25% slower here on an H100 80GB HBM3 at 700 W).
//
// Tile kernel: a block copies its slice of `rows` rows (one contiguous block
// of the table) into shared memory with the Tensor Memory Accelerator's bulk
// copy (one thread issues it; an mbarrier counts its bytes); each warp
// scores R of the rows against TILE_Q of the slots at a time, the queries
// read from L2 (L1 after the first warp): R = 8 for narrow rows, where a
// (row, query) dot is a few FMAs a lane against 5 butterfly steps, so the
// tile's 16 butterflies are folded into one transposed reduction (at each
// step a lane keeps half of its partial sums and trades the other half with
// its partner): 16 shuffles for the 16 sums instead of 80; R = 1 for wide
// rows.
//
// Every (row, query) pair is scored with row_dot's arithmetic (scoring.cuh):
// lane l takes the 16-byte chunks l, l + 32, ... in order, fmaf(q, x, acc)
// over each chunk's elements, then the butterfly's tree (the folded
// reduction adds the same pairs in the same tree: a + b == b + a); so both
// kernels and routes give the first port's bits, whatever the order of the
// slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int ROW_UNROLL = 8;  // a lane's chunks of its row in flight on the row kernel
constexpr int TILE_Q = 2;      // slots a warp scores its R rows against at once
constexpr uint32_t BULK_MAX = 32768;  // bytes of one bulk copy

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// VEC consecutive elements widened to f32, as Loader (scoring.cuh) widens
// them, by plain loads (shared memory, or global memory through L1).
template <typename T, int VEC>
struct PlainLoader;

template <>
struct PlainLoader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = p[0]; }
};

template <>
struct PlainLoader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <>
struct PlainLoader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct PlainLoader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// The slots a block serves (count 0: none) and their bucket. The slot
// route: group g is slot g, which probes bucket probe[g]. The bucket route
// (kByBucket): group g is the g-th bin that has slots (live[1 + g], while g <
// live[0]; bin 0: bucket ids < 0, bin b + 1: bucket b, bin nbuckets + 1: ids
// >= nbuckets), its slots slots[ends[bin - 1] .. ends[bin]) (from 0 for bin
// 0).
template <bool kByBucket>
struct BlockSlots {
  const int* slots;
  int group, start, count, bucket;
  __device__ __forceinline__ BlockSlots(const int* probe, const int* slots_, const int* ends,
                                        const int* live, int group_)
      : slots(slots_), group(group_), start(0), count(1) {
    if constexpr (!kByBucket) {
      bucket = __ldg(probe + group);
    } else if (group >= __ldg(live)) {
      count = 0;
    } else {
      const int bin = __ldg(live + 1 + group);
      start = bin == 0 ? 0 : __ldg(ends + bin - 1);
      count = __ldg(ends + bin) - start;
      bucket = bin - 1;
    }
  }
  __device__ __forceinline__ int operator[](int j) const {
    if constexpr (!kByBucket) {
      return group;
    } else {
      return __ldg(slots + start + j);
    }
  }
};

// ---- the row kernel ----

// One lane's VEC-element chunk of a row as it is loaded (16 bytes, or one
// element), widened to f32 only where it is used, so that a lane keeps
// ROW_UNROLL chunks in flight in few registers.
template <typename T, int VEC>
struct Chunk {
  static constexpr bool kWide = VEC * sizeof(T) == 16;
  static_assert(kWide || VEC == 1, "16-byte chunks or single elements");
  using Raw = typename std::conditional<kWide, uint4, T>::type;
  static __device__ __forceinline__ Raw load(const T* p) {
    if constexpr (kWide) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      return p[0];
    }
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&v)[VEC]) {
    if constexpr (!kWide) {
      v[0] = to_f32(r);
    } else if constexpr (std::is_same<T, float>::value) {
      v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
};

// The lane's chunks c0, c0 + 32, ..., c0 + 32 (ROW_UNROLL - 1) of a row
// (those below nvec), as loaded.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunks(typename Chunk<T, VEC>::Raw (&xr)[ROW_UNROLL],
                                            const T* __restrict__ row, int nvec, int c0) {
#pragma unroll
  for (int u = 0; u < ROW_UNROLL; ++u) {
    const int c = c0 + 32 * u;
    if (c < nvec) xr[u] = Chunk<T, VEC>::load(row + (size_t)c * VEC);
  }
}

// acc += those chunks times the query's (as stored, in shared or global
// memory), in row_dot's order.
template <typename T, int VEC>
__device__ __forceinline__ void fma_chunks(const typename Chunk<T, VEC>::Raw (&xr)[ROW_UNROLL],
                                           const T* qrow, int nvec, int c0, float& acc) {
#pragma unroll
  for (int u = 0; u < ROW_UNROLL; ++u) {
    const int c = c0 + 32 * u;
    if (c < nvec) {
      float xv[VEC], qv[VEC];
      Chunk<T, VEC>::widen(xr[u], xv);
      PlainLoader<T, VEC>::load(qrow + (size_t)c * VEC, qv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(qv[e], xv[e], acc);
    }
  }
}

// The slot route over wide rows, and for one query. Block b scores rows [s *
// WARPS, s * WARPS + WARPS) of slot b / nsplit's bucket (s = b % nsplit),
// warp w row s * WARPS + w, into out[slot * cap + r]: each lane issues its
// row's first chunks, the block copies the slot's query into shared memory
// (dynamic: d elements of T; cp.async 16 bytes a thread when VEC > 1), and
// after one barrier each warp multiplies as its row arrives.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    probed_scan_row_kernel(const T* __restrict__ q, const T* __restrict__ x,
                           const float* __restrict__ norms, const int* __restrict__ probe,
                           float* __restrict__ out, int nprobe, int nbuckets, int cap, int d,
                           int nsplit) {
  extern __shared__ __align__(16) unsigned char qraw[];
  T* qs = reinterpret_cast<T*>(qraw);
  const int slot = (int)(blockIdx.x / nsplit);
  const int r = (int)(blockIdx.x % nsplit) * WARPS + (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = __ldg(probe + slot);
  const bool live = b >= 0 && b < nbuckets && r < cap;  // warp-uniform
  const int nvec = d / VEC;
  const long long row = (long long)(live ? b : 0) * cap + r;
  const T* xrow = x + row * d;
  typename Chunk<T, VEC>::Raw xr[ROW_UNROLL];
  float nr = 0.f;
  if (live) {  // in flight while the block stages the query
    load_chunks<T, VEC>(xr, xrow, nvec, lane);
    nr = __ldg(norms + row);
  }
  const T* qrow = q + (size_t)(slot / nprobe) * d;
  if constexpr (Chunk<T, VEC>::kWide) {
    for (int i = threadIdx.x; i < nvec; i += THREADS)
      cp_async16(smem_u32(qs + (size_t)i * VEC), qrow + (size_t)i * VEC, true);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < d; i += THREADS) qs[i] = qrow[i];
  }
  __syncthreads();
  if (r >= cap) return;
  float score = INFINITY;
  if (live) {
    float acc = 0.f;
    for (int c0 = lane;;) {
      fma_chunks<T, VEC>(xr, qs, nvec, c0, acc);
      c0 += 32 * ROW_UNROLL;
      if (c0 >= nvec) break;
      load_chunks<T, VEC>(xr, xrow, nvec, c0);
    }
    score = score_of(nr, warp_sum(acc));
  }
  if (lane == 0) out[(size_t)slot * cap + r] = score;
}

// ---- the tile kernel ----

// bytes from global to shared memory by the Tensor Memory Accelerator (one
// bulk copy; 16-byte aligned, a multiple of 16), counted on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Folds the N partial sums of each lane (N dots, N a power of two) through
// the butterfly offsets OFF, OFF / 2, ..., 1: while a lane holds more than
// one sum it keeps half of them (the upper half where its bit OFF is set)
// plus its partner's, and sends the other half; the last sum goes on as
// row_dot's butterfly. Afterwards lane l holds dot l >> (5 - log2 N)'s sum,
// each dot's pairs added in row_dot's tree.
template <int N, int OFF>
struct FoldSums {
  static __device__ __forceinline__ void run(float* acc, int lane) {
    if constexpr (OFF > 0) {
      if constexpr (N > 1) {
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int k = 0; k < N / 2; ++k) {
          const float send = upper ? acc[k] : acc[k + N / 2];
          const float keep = upper ? acc[k + N / 2] : acc[k];
          acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        }
        FoldSums<N / 2, OFF / 2>::run(acc, lane);
      } else {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], OFF);
        FoldSums<1, OFF / 2>::run(acc, lane);
      }
    }
  }
};

// q_j . rows[k] for the nrows (<= R) rows of a shared-memory tile (row
// stride d) and TILE_Q query rows in global memory (16-byte aligned when
// VEC > 1; null past the last slot), each (query, row) pair in row_dot's
// lane order; returns to lane l the sum of pair l >> (5 - log2(TILE_Q R)),
// pair j * R + k (FoldSums).
template <typename T, int VEC, int R>
__device__ __forceinline__ float dot_tile(const T* rows, int nrows,
                                          const T* const (&qrow)[TILE_Q], int d, int lane) {
  float acc[TILE_Q * R];
#pragma unroll
  for (int k = 0; k < TILE_Q * R; ++k) acc[k] = 0.f;
  const int nvec = d / VEC;
#pragma unroll 2
  for (int c = lane; c < nvec; c += 32) {
    float qv[TILE_Q][VEC];
#pragma unroll
    for (int j = 0; j < TILE_Q; ++j)
      if (qrow[j] != nullptr) Loader<T, VEC>::load(qrow[j] + (size_t)c * VEC, qv[j]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < nrows) {
        float xv[VEC];
        PlainLoader<T, VEC>::load(rows + (size_t)k * d + (size_t)c * VEC, xv);
#pragma unroll
        for (int j = 0; j < TILE_Q; ++j) {
          if (qrow[j] != nullptr) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j * R + k] = fmaf(qv[j][e], xv[e], acc[j * R + k]);
          }
        }
      }
    }
  }
  FoldSums<TILE_Q * R, 16>::run(acc, lane);
  return acc[0];
}

// Block b takes row slice s = b % nslices (rows [s * rows, s * rows + rows))
// of the bucket of its slots (those of group b / nslices: BlockSlots) and
// scores it for each slot into out[slot * cap + r], each warp R rows against
// TILE_Q slots at a time. Dynamic shared memory: the slice's rows (rows x d
// of T, 16-byte aligned), then their norms.
template <typename T, int VEC, int R, bool kByBucket>
__global__ void __launch_bounds__(THREADS)
    probed_scan_tile_kernel(const T* __restrict__ q, const T* __restrict__ x,
                            const float* __restrict__ norms, const int* __restrict__ probe,
                            const int* __restrict__ order, const int* __restrict__ ends,
                            const int* __restrict__ live, float* __restrict__ out, int nprobe,
                            int nbuckets, int cap, int d, int rows, int nslices) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t staged;  // the slice's bulk copies land on this barrier
  const BlockSlots<kByBucket> bs(probe, order, ends, live, (int)(blockIdx.x / nslices));
  if (bs.count <= 0) return;  // past the last bin that has slots
  const int r0 = (int)(blockIdx.x % nslices) * rows;
  const int nr = min(cap - r0, rows);
  if (bs.bucket < 0 || bs.bucket >= nbuckets) {
    for (int i = threadIdx.x; i < bs.count * nr; i += THREADS)
      out[(size_t)bs[i / nr] * cap + r0 + i % nr] = INFINITY;
    return;
  }
  const long long base = (long long)bs.bucket * cap + r0;
  T* xs = reinterpret_cast<T*>(smem);
  float* ns = reinterpret_cast<float*>(smem + (((size_t)rows * d * sizeof(T) + 15) & ~(size_t)15));
  const T* src = x + base * d;
  if constexpr (VEC * sizeof(T) == 16) {  // the slice is one contiguous, 16-byte aligned block
    const uint32_t bar = smem_u32(&staged);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const uint32_t bytes = (uint32_t)((size_t)nr * d * sizeof(T));
      mbar_expect_tx(bar, bytes);
      for (uint32_t off = 0; off < bytes; off += BULK_MAX)
        bulk_load(smem_u32(smem + off), reinterpret_cast<const unsigned char*>(src) + off,
                  min(BULK_MAX, bytes - off), bar);
    }
    for (int i = threadIdx.x; i < nr; i += THREADS) ns[i] = __ldg(norms + base + i);
    __syncthreads();  // the barrier is initialized, the norms are in
    mbar_wait(bar, 0);
  } else {
    for (int i = threadIdx.x; i < nr * d; i += THREADS) xs[i] = src[i];
    for (int i = threadIdx.x; i < nr; i += THREADS) ns[i] = __ldg(norms + base + i);
    __syncthreads();
  }

  constexpr int PAIRS_LOG2 = ilog2(TILE_Q * R);
  static_assert(TILE_Q * R == 1 << PAIRS_LOG2 && PAIRS_LOG2 <= 5, "a power of two, at most 32");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = (nr + R - 1) / R;
  const int pair = lane >> (5 - PAIRS_LOG2);  // the (query, row) whose sum this lane ends with
  const int mine_q = pair / R;
  const int mine_r = pair % R;
  const bool writes = (lane & ((32 >> PAIRS_LOG2) - 1)) == 0;
  const int tasks = (bs.count + TILE_Q - 1) / TILE_Q * groups;
  for (int task = warp; task < tasks; task += WARPS) {
    const int j0 = task / groups * TILE_Q;
    const int i0 = (task % groups) * R;
    int slot[TILE_Q];
    const T* qrow[TILE_Q];
#pragma unroll
    for (int j = 0; j < TILE_Q; ++j) {
      slot[j] = j0 + j < bs.count ? bs[j0 + j] : -1;
      qrow[j] = slot[j] >= 0 ? q + (size_t)(slot[j] / nprobe) * d : nullptr;
    }
    const float dot = dot_tile<T, VEC, R>(xs + (size_t)i0 * d, min(R, nr - i0), qrow, d, lane);
    int mine_slot = slot[0];
#pragma unroll
    for (int j = 1; j < TILE_Q; ++j) mine_slot = mine_q == j ? slot[j] : mine_slot;
    if (writes && mine_slot >= 0 && i0 + mine_r < nr)
      out[(size_t)mine_slot * cap + r0 + i0 + mine_r] = score_of(ns[i0 + mine_r], dot);
  }
}

// ---- launches ----

template <typename T, int VEC>
cudaError_t launch_rows(const void* q, const void* x, const void* norms, const void* probe,
                        void* out, int nq, int nprobe, int nbuckets, int cap, int d,
                        cudaStream_t stream) {
  const int nsplit = (cap + WARPS - 1) / WARPS;
  const long long blocks = (long long)nq * nprobe * nsplit;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = ((size_t)d * sizeof(T) + 15) & ~(size_t)15;
  auto kernel = probed_scan_row_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(norms),
      static_cast<const int*>(probe), static_cast<float*>(out), nprobe, nbuckets, cap, d, nsplit);
  return cudaGetLastError();
}

template <typename T, int VEC, int R, bool kByBucket>
cudaError_t launch_tiles(const void* q, const void* x, const void* norms, const void* probe,
                         const void* order, const void* ends, const void* live, void* out,
                         int groups, int nprobe, int nbuckets, int cap, int d, int rows, int smem,
                         cudaStream_t stream) {
  if (rows < 1 || (size_t)smem < (((size_t)rows * d * sizeof(T) + 15) & ~(size_t)15) +
                                     (size_t)rows * sizeof(float))
    return cudaErrorInvalidValue;
  const int nslices = (cap + rows - 1) / rows;
  const long long blocks = (long long)groups * nslices;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = probed_scan_tile_kernel<T, VEC, R, kByBucket>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(norms),
      static_cast<const int*>(probe), static_cast<const int*>(order),
      static_cast<const int*>(ends), static_cast<const int*>(live), static_cast<float*>(out),
      nprobe, nbuckets, cap, d, rows, nslices);
  return cudaGetLastError();
}

// The route's launch for one table type: rows 0, the row kernel (slot
// route); else the tile kernel, r rows a warp (1 or 8), its blocks by slot
// (no order) or by bin that has slots (at most min(slots, bins) of them).
template <typename T, int VEC>
cudaError_t launch(const void* q, const void* x, const void* norms, const void* probe,
                   const void* order, const void* ends, const void* live, void* out, int nq,
                   int nprobe, int nbuckets, int cap, int d, int rows, int r, int smem,
                   cudaStream_t s) {
  const int slots = nq * nprobe;
  if (rows == 0) {
    if (order != nullptr) return cudaErrorInvalidValue;
    return launch_rows<T, VEC>(q, x, norms, probe, out, nq, nprobe, nbuckets, cap, d, s);
  }
#define ISE_TILES(R)                                                                          \
  if (r == R) {                                                                               \
    if (order == nullptr)                                                                     \
      return launch_tiles<T, VEC, R, false>(q, x, norms, probe, order, ends, live, out,       \
                                            slots, nprobe, nbuckets, cap, d, rows, smem, s);  \
    return launch_tiles<T, VEC, R, true>(q, x, norms, probe, order, ends, live, out,          \
                                         min(slots, nbuckets + 2), nprobe, nbuckets, cap, d,  \
                                         rows, smem, s);                                      \
  }
  ISE_TILES(8)
  ISE_TILES(1)
#undef ISE_TILES
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int vec, const void* q, const void* x, const void* norms,
                     const void* probe, const void* order, const void* ends, const void* live,
                     void* out, int nq, int nprobe, int nbuckets, int cap, int d, int rows,
                     int r, int smem, cudaStream_t s) {
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(q, x, norms, probe, order, ends, live, out, nq, nprobe, nbuckets,
                            cap, d, rows, r, smem, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(q, x, norms, probe, order, ends, live, out, nq, nprobe, nbuckets,
                            cap, d, rows, r, smem, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(q, x, norms, probe, order, ends, live, out, nq, nprobe,
                                    nbuckets, cap, d, rows, r, smem, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(q, x, norms, probe, order, ends, live, out, nq, nprobe,
                                    nbuckets, cap, d, rows, r, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16 table (the query in the same type,
// its rows 16-byte aligned when vec > 1). vec: 1, or 16 bytes' worth of
// elements (4 for f32, 8 for bf16) when the table's rows are 16-byte
// aligned. probe: (nq, nprobe) int32 bucket ids. On the plan of ops/ivf.py
// probed_scan_plan: rows 0, the row kernel; else the tile kernel with
// `rows` table rows a block in smem bytes of dynamic shared memory, r rows
// a warp (8 or 1). out: (nq, nprobe * cap) f32. Each returns the
// cudaError_t of its launch (0 = success).

// The slot route.
int ise_probed_scan(int dtype, const void* q, const void* x, const void* norms, const void* probe,
                    void* out, int nq, int nprobe, int nbuckets, int cap, int d, int vec,
                    int rows, int r, int smem, void* stream) {
  return dispatch(dtype, vec, q, x, norms, probe, nullptr, nullptr, nullptr, out, nq, nprobe,
                  nbuckets, cap, d, rows, r, smem, static_cast<cudaStream_t>(stream));
}

// The bucket route (the tile kernel): order (nq * nprobe int32) the slots
// grouped by bucket, ends (nbuckets + 2 int32) each bin's end in it and
// live (nbuckets + 3 int32) the number of bins that have slots, then their
// ids (ops/topk.py group_order).
int ise_probed_scan_bucket(int dtype, const void* q, const void* x, const void* norms,
                           const void* probe, const void* order, const void* ends,
                           const void* live, void* out, int nq, int nprobe, int nbuckets,
                           int cap, int d, int vec, int rows, int r, int smem, void* stream) {
  if (rows < 1 || order == nullptr || ends == nullptr || live == nullptr)
    return cudaErrorInvalidValue;
  return dispatch(dtype, vec, q, x, norms, probe, order, ends, live, out, nq, nprobe, nbuckets,
                  cap, d, rows, r, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
