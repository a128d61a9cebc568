// The f32 warpgroup-MMA sweep and rescore of groupmin_tf32.cu (the design
// is described there), as device routines that take their work item in
// place of blockIdx.x: flat_tf32_kernel calls them with blockIdx.x, the
// merged search (topk_merged.cu) from one persistent launch, so both run
// the same instructions on the same operands.
//
// A block's dynamic shared memory holds the ring of TF32_STAGES stages,
// the consumers' warp mins and the ring's full and empty mbarriers
// (Tf32Layout). The producer thread and the consumer warpgroups count the
// stages they have passed through the ring from `base` on, so a persistent
// block carries the mbarriers' phases from one work item to the next; the
// kernel's one item starts at base 0.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mma.cuh"
#include "scoring.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TF32_GROUP = 128;      // rows per group: two consumer warpgroups of 64
constexpr int TF32_STAGES = 4;
constexpr int TF32_CONSUMERS = 256;  // two warpgroups
constexpr int TF32_THREADS = TF32_CONSUMERS + 128;  // and the producer warpgroup
constexpr int TF32_KSTEPS = SW128_COLS / 8;         // k-steps per stage: one sum
constexpr int TF32_A_BYTES = TF32_GROUP * SW128_COLS * 4;

template <int BN>
struct Tf32Layout {
  static constexpr int B_BYTES = BN * SW128_COLS * 4;  // one query half
  static constexpr int STAGE = TF32_A_BYTES + 2 * B_BYTES;
  static constexpr int RED = 2 * (TF32_CONSUMERS / 32) * BN * 4;  // two buffers of warp mins
  // the ring (1024-byte aligned, the swizzle's period), the warp mins, then
  // the stages' full and empty mbarriers
  static constexpr size_t SMEM = 1024 + (size_t)TF32_STAGES * STAGE + RED + 2 * TF32_STAGES * 8;
};

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TF32_CONSUMERS) : "memory");
}

// The block's dynamic shared memory (smem_raw) in Tf32Layout: the ring's
// 1024-byte aligned start (and its shared address), the warp mins, the
// first full and empty mbarriers (TF32_STAGES of each, 8 bytes apart).
template <int BN>
struct Tf32Smem {
  unsigned char* smem;
  uint32_t ring;
  float* red;
  uint32_t full;
  uint32_t empty;
};

template <int BN>
__device__ __forceinline__ Tf32Smem<BN> tf32_smem(unsigned char* smem_raw) {
  using L = Tf32Layout<BN>;
  Tf32Smem<BN> m;
  m.smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  m.ring = smem_u32(m.smem);
  m.red = reinterpret_cast<float*>(m.smem + TF32_STAGES * L::STAGE);
  m.full = m.ring + TF32_STAGES * L::STAGE + L::RED;
  m.empty = m.full + TF32_STAGES * 8;
  return m;
}

// Thread 0 initializes the ring's mbarriers; the caller's barrier follows.
__device__ __forceinline__ void tf32_init_barriers(uint32_t full, uint32_t empty) {
  for (int s = 0; s < TF32_STAGES; ++s) {
    mbar_init(full + 8 * s, 1);                     // the producer's arrival
    mbar_init(empty + 8 * s, TF32_CONSUMERS / 32);  // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One work item. Phase 1 (RESCORE false): item b takes query tile q0 = (b %
// nqt) * BN and the slice of groups [g0, g1) = [(b / nqt) * gps, + gps).
// Phase 2: item b is the (query qi, candidate group) pair of slot b, the
// group group_of(slot), on the query tile phase 1 gives the query.
struct Tf32Work {
  long long slot;
  int qi;
  int q0;
  int g0;
  int g1;
};

template <int BN, bool RESCORE, class GroupOf>
__device__ __forceinline__ Tf32Work tf32_work(unsigned b, int nqt, int gps, int ngroups, int t,
                                              GroupOf group_of) {
  Tf32Work w;
  w.slot = b;
  w.qi = RESCORE ? (int)(w.slot / t) : 0;
  w.q0 = RESCORE ? w.qi / BN * BN : (int)(b % nqt) * BN;
  w.g0 = RESCORE ? group_of(w.slot) : (int)(b / nqt) * gps;
  w.g1 = RESCORE ? w.g0 + 1 : min(w.g0 + gps, ngroups);
  return w;
}

// The producer thread: the item's ntiles = (g1 - g0) * nkc stages, each the
// group's 128 rows and both query halves' BN rows over 32 columns, into the
// ring at the running stage count base + i.
template <int BN>
__device__ __forceinline__ void tf32_produce(const Tf32Smem<BN>& m, const CUtensorMap* xmap,
                                             const CUtensorMap* himap, const CUtensorMap* lomap,
                                             const Tf32Work& w, int nkc, int ntiles, int base) {
  using L = Tf32Layout<BN>;
  for (int i = 0; i < ntiles; ++i) {
    const int k = base + i;
    const int s = k % TF32_STAGES;
    if (k >= TF32_STAGES) mbar_wait(m.empty + 8 * s, (k / TF32_STAGES - 1) & 1);
    const uint32_t st = m.ring + s * L::STAGE;
    const int row0 = (w.g0 + i / nkc) * TF32_GROUP;
    const int k0 = (i % nkc) * SW128_COLS;
    mbar_expect_tx(m.full + 8 * s, L::STAGE);
    tma_load_3d(st, xmap, m.full + 8 * s, k0, row0, 0);
    tma_load_3d(st + TF32_A_BYTES, himap, m.full + 8 * s, k0, w.q0, 0);
    tma_load_3d(st + TF32_A_BYTES + L::B_BYTES, lomap, m.full + 8 * s, k0, w.q0, 0);
  }
}

// The two consumer warpgroups (threads 0 .. TF32_CONSUMERS - 1): the item's
// stages from the ring, then per group its mins (phase 1: out (nq,
// ngroups)) or its 128 scores (phase 2: out[slot * 128 + r], +inf past n).
template <int BN, bool RESCORE>
__device__ __forceinline__ void tf32_consume(const Tf32Smem<BN>& m, const float* norms, float* out,
                                             int nq, long long n, int ngroups, const Tf32Work& w,
                                             int nkc, int ntiles, int base) {
  using L = Tf32Layout<BN>;
  constexpr int R = BN / 2;  // accumulators per thread
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // warp w multiplies the group's rows wrow .. wrow + 15 (warpgroup w / 4
  // rows 64 (w / 4) ..); in the swizzle, 16-byte chunk c of row r sits at r
  // * 128 + ((c ^ (r % 8)) * 16), and r % 8 = lane % 8 for this lane's
  // ldmatrix row
  const int wrow = warp * 16;
  const uint32_t arow = (uint32_t)(wrow + (lane & 15)) * 128;
  const int achunk = lane >> 4;
  float acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int k = base + i;
    const int s = k % TF32_STAGES;
    mbar_wait(m.full + 8 * s, (k / TF32_STAGES) & 1);
    const uint32_t st = m.ring + s * L::STAGE;
    // the rows' fragments split and the descriptors made before the group,
    // so nothing but wgmmas runs between its fence and its commit
    uint32_t ah[TF32_KSTEPS][4], al[TF32_KSTEPS][4];
    uint64_t dh[TF32_KSTEPS], dl[TF32_KSTEPS];
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(st + arow + (uint32_t)(((2 * kk + achunk) ^ (lane & 7)) << 4), r);
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(r[e], ah[kk][e], al[kk][e]);
      dh[kk] = wgmma_desc_sw128(st + TF32_A_BYTES + kk * MMA_KBYTES);
      dl[kk] = wgmma_desc_sw128(st + TF32_A_BYTES + L::B_BYTES + kk * MMA_KBYTES);
    }
    float sum[R];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      sum[e] = 0.f;
      fence_operand(sum[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk) {
      wgmma_tf32<BN>(sum, al[kk], dh[kk], 1);  // x_lo . q_hi
      wgmma_tf32<BN>(sum, ah[kk], dl[kk], 1);  // x_hi . q_lo
      wgmma_tf32<BN>(sum, ah[kk], dh[kk], 1);  // x_hi . q_hi
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < R; ++e) fence_operand(sum[e]);
#pragma unroll
    for (int kk = 0; kk < TF32_KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(ah[kk][e]);
        fence_operand(al[kk][e]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(m.empty + 8 * s);  // this warp is done with the stage
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = __fadd_rn(acc[e], sum[e]);

    if (i % nkc != nkc - 1) continue;
    // the group's last stage: its scores. This thread holds rows wrow +
    // lane / 4 + 8 h, columns 8 j + 2 (lane % 4) + e in acc[4 j + 2 h + e].
    const int g = w.g0 + i / nkc;
    float nr[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)g * TF32_GROUP + wrow + (lane >> 2) + 8 * h;
      ok[h] = row < n;
      nr[h] = ok[h] ? __ldg(norms + row) : 0.f;
    }
    if constexpr (RESCORE) {
      const int c = w.qi - w.q0;  // the query's column
      if ((lane & 3) == (c & 7) / 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + 2 * (lane & 3) + e == c) dot = acc[4 * j + 2 * h + e];
          out[w.slot * TF32_GROUP + wrow + (lane >> 2) + 8 * h] =
              ok[h] ? score_of(nr[h], dot) : INFINITY;
        }
      }
    } else {
      float* rb = m.red + ((i / nkc) & 1) * (TF32_CONSUMERS / 32) * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mn = INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mn = fminf(mn, ok[h] ? score_of(nr[h], acc[4 * j + 2 * h + e]) : INFINITY);
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 4));
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 8));
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 16));
          if (lane < 4) rb[warp * BN + 8 * j + 2 * lane + e] = mn;
        }
      consumer_barrier();
      for (int c = threadIdx.x; c < BN && w.q0 + c < nq; c += TF32_CONSUMERS) {
        float mn = rb[c];
#pragma unroll
        for (int wi = 1; wi < TF32_CONSUMERS / 32; ++wi) mn = fminf(mn, rb[wi * BN + c]);
        out[(size_t)(w.q0 + c) * ngroups + g] = mn;
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
  }
}

// The tensor maps of both phases: the store's rows in boxes of a group, the
// queries' halves in boxes of bn.
bool flat_tf32_maps(CUtensorMap (&maps)[3], const void* x, const void* qhi, const void* qlo,
                    int nq, long long n, int d, int bn) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(qhi) |
                        reinterpret_cast<uintptr_t>(qlo)) % 16 == 0;
  return nq >= 1 && n >= 1 && n <= (long long)INT_MAX - TF32_GROUP && d >= 4 && d % 4 == 0 &&
         aligned && encoder() && tensor_map(&maps[0], x, d, n, d, TF32_GROUP, 1, n * d, 1) &&
         tensor_map(&maps[1], qhi, d, nq, d, bn, 1, (long long)nq * d, 1) &&
         tensor_map(&maps[2], qlo, d, nq, d, bn, 1, (long long)nq * d, 1);
}

}  // namespace
