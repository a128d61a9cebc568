"""Certified two-phase exact top-k — the flat search's hot op.

Port of ``image_search_engine_tpu/ops/topk_pallas.py`` (``topk_twophase``,
``topk_twophase_safe``, ``quantize_store_int8``, and ``topk_pallas`` as
:func:`topk_running`: one pass with running top-k accumulators,
``csrc/topk_running.cu``) for f32, bf16 and int8 stores:

  1. ``groupmin``: scores norms - 2 q.x against every store row and keeps
     the min of each 128-row group, (Q, ngroups);
  2. ``select_topt``: per query, the t = k + margin groups with the
     smallest mins, ascending, ties to the lowest group id;
  3. ``rescore``: scores every row of those t groups, (Q, t*128);

then a stable sort over the candidates (ties to the lowest candidate
position, i.e. the earlier selected group, as ``lax.top_k``), the id
rebuild and the certificate "k-th final score <= t-th selected group min"
(every pruned group's min is >= that threshold, so True proves no pruned
row could beat the k-th result). An int8 store runs ``groupmin_q8`` and
``rescore_q8`` in steps 1 and 3: the query is quantized per row like the
store, the int8 x int8 products are exact int32 sums, and the per-row
scales fold into an f32 epilogue.

Each step is a hand-written CUDA kernel (``csrc/topk_twophase.cu``,
``csrc/topk_twophase_q8.cu``; step 2 ``csrc/select_topt.cu``, a radix
select for every t) with a plain PyTorch version beside it; a
bf16 store's steps 1 and 3 and an int8 store's step 1 beyond
``DP4A_MAX_Q`` queries run on tensor cores (``csrc/mma.cuh``,
``csrc/groupmin_mma.cuh``), an f32 store's steps 1 and 3 beyond
``F32_CUDA_CORE_MAX_Q`` queries on the warpgroup MMA with a 3xTF32 split
(``csrc/groupmin_tf32.cu``, where the rows are whole 16-byte units),
smaller f32 and int8 batches on CUDA cores. Each store dtype and batch
size scores a row the same way in steps 1 and 3 (int8: the same exact
int32 sum, with ``__dp4a`` in step 3), so a group's step-1 min is bit for
bit the min of its step-3 scores. A wrapper
runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

Scores live in the "minimize" domain: l2 uses the squared store norms; ip
halves the query (int8: its scale) and uses zero norms except at rows
poisoned with ``PAD_NORM``, so score = -q.x (or ~PAD_NORM on a pad row). The
query is cast to the store dtype (int8: quantized) before scoring, as the
JAX package does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.distances import l2_normalize, stable_smallest
from image_search_engine_tpu_torch.parallel.topk import ip_penalty

log = logging.getLogger(__name__)

GROUP = 128  # candidate-group width (rows)
#: dynamic shared memory a kernel block may ask for (H100: 227 KB per block)
_SMEM_BYTES = 200 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: int8 rows wider than this could overflow the int32 sum (127^2 * d >= 2^31)
MAX_Q8_DIM = 133_000
#: batches of up to this many queries take the int8 sweep on CUDA cores,
#: larger ones the tensor-core sweep (over 1M x 2048 on the H100 the first
#: is ~7% faster at Q = 1 and 4, the second ~17% faster at Q = 8:
#: chip_smoke.py phase 4, PERF.md)
DP4A_MAX_Q = 4
#: batches of up to this many queries score an f32 store on CUDA cores
#: (``row_dot``, IEEE f32 FMAs) in both phases, larger ones on tensor cores
#: with a 3xTF32 split where the rows allow (over 1M x 2048 on the H100 the
#: first is faster at Q = 1 and 2, the second from Q = 4 on: chip_smoke.py
#: phase 1, PERF.md)
F32_CUDA_CORE_MAX_Q = 2
#: store rows per float64 product in the int8 plain versions (bounds the copy)
_Q8_REF_ROWS = 1 << 14


def num_groups(n: int) -> int:
    return -(-n // GROUP)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors are on a CUDA device (launch the kernel),
    False when they are on the CPU (run the plain version)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no two-phase kernel for device {dev}")


def _check_scoring_args(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32 or bfloat16, got {x.dtype} "
                         "(an int8 store is scored by the _q8 kernels)")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if q.dtype != x.dtype:
        raise ValueError(f"query dtype {q.dtype} must equal the store dtype {x.dtype}")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (x.shape[0],):
        raise ValueError("norms must be float32 of shape (N,)")
    for name, t in (("q", q), ("x", x), ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_q8_args(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                   scales: torch.Tensor, norms: torch.Tensor) -> None:
    if q.dtype != torch.int8 or x.dtype != torch.int8:
        raise ValueError(f"want int8 query and store codes, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if q.shape[1] >= MAX_Q8_DIM:
        raise ValueError(f"d={q.shape[1]} could overflow the int32 product (d < {MAX_Q8_DIM})")
    for name, t, n in (("qscale", qscale, q.shape[0]), ("scales", scales, x.shape[0]),
                       ("norms", norms, x.shape[0])):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},)")
    for name, t in (("q", q), ("qscale", qscale), ("x", x), ("scales", scales),
                    ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(x: torch.Tensor) -> int:
    """Store elements per 16-byte load, or 1 when rows are not 16-byte aligned."""
    per = 16 // x.element_size()
    return per if x.shape[1] % per == 0 and x.data_ptr() % 16 == 0 else 1


def _vec_q8(q: torch.Tensor, x: torch.Tensor) -> int:
    """16 when the int8 store and query rows are 16-byte aligned, else 1."""
    return 16 if _vec(x) == 16 and q.data_ptr() % 16 == 0 else 1


def _query_tile(nq: int, row_bytes: int) -> int:
    """Queries per phase-1 block: 1, 2, 4 or 8, as many as the batch fills,
    halved until their rows fit the shared-memory budget."""
    qt = next(t for t in (1, 2, 4, 8) if t >= min(nq, 8))
    while qt > 1 and qt * row_bytes > _SMEM_BYTES:
        qt //= 2
    if row_bytes > _SMEM_BYTES:
        raise ValueError(f"a {row_bytes}-byte query row exceeds the kernels' shared-memory tile")
    return qt


# The tensor-core sweep of bf16 and int8 stores and the bf16 rescore
# (csrc/groupmin_mma.cuh groupmin_mma_kernel, csrc/topk_twophase.cu
# rescore_mma_kernel; csrc/mma.cuh). Their tile arithmetic counts bytes: a
# k-step is 32 bytes of a row (16 bf16 values, 32 int8 codes).
#: queries per phase-1 block
MMA_BQ = (16, 32, 64, 128)
#: bytes of a row per shared-memory stage the sweep tries, widest first
_MMA_KC_BYTES = (256, 128, 64, 32)
_MMA_K_BYTES = 32  # bytes of a row per mma k-step (MMA_KBYTES in csrc/mma.cuh)
_MMA_PAD_BYTES = 16  # appended to every shared-memory row (SMEM_PAD_BYTES)
_MMA_WARPS = 8  # warps per phase-1 block (WARPS in csrc/scoring.cuh)
#: shared memory under which two sweep blocks fit one SM (228 KB, 1 KB each reserved)
_MMA_SMEM_TWO_BLOCKS = 113 * 1024
#: blocks the sweep aims for (~15 waves of two blocks on each of 132 SMs)
_MMA_TARGET_BLOCKS = 4096
_MMA_MIN_SLICE = 4  # groups per block at least, so a block's start-up is amortized
_MMA_MAX_SLICE = 16  # groups per block at most, so concurrent slices stay in L2
_RESCORE_MMA_WARPS = 4  # warps per phase-2 block, one (query, group) pair, 32 rows a warp
_RESCORE_MMA_KC = 128  # store columns per phase-2 stage (two stages per warp)
_GRID_MAX = 2 ** 31 - 1  # CUDA's gridDim.x limit


def _groupmin_mma_smem(bq: int, nq: int, dp: int, kc: int, resident: bool,
                       itemsize: int = 2) -> int:
    """Shared-memory bytes of a sweep block over elements of ``itemsize``
    bytes (groupmin_mma_smem in the .cuh): a resident query tile (min(bq, nq
    + 1) rows: a batch of fewer than bq queries stages its own and one zero
    row), two stages of 128 store rows (and, streamed, bq query rows), the
    cross-warp mins."""
    wn = _MMA_WARPS // (2 if bq >= 32 else 1)
    qrows, srows = (min(bq, nq + 1), GROUP) if resident else (0, GROUP + bq)
    return (qrows * (dp * itemsize + _MMA_PAD_BYTES)
            + 2 * srows * (kc * itemsize + _MMA_PAD_BYTES) + wn * bq * 4)


@dataclass(frozen=True)
class SweepGrid:
    """A tensor-core sweep's blocks for Q = nq queries over N rows (the
    bf16 and int8 sweep's, :class:`MmaPlan`, and the f32 one's,
    :func:`wgmma_plan`): block b takes query tile b % nqt (``bq`` queries)
    and the slice of ``gps`` 128-row groups b // nqt."""

    nq: int
    n: int
    bq: int
    gps: int

    @property
    def ngroups(self) -> int:
        return num_groups(self.n)

    @property
    def nqt(self) -> int:
        return -(-self.nq // self.bq)

    @property
    def grid(self) -> int:
        return -(-self.ngroups // self.gps) * self.nqt

    def block_tiles(self, b: torch.Tensor):
        """(q0, q1, g0, g1) of phase-1 blocks ``b``: the queries [q0, q1) and
        groups [g0, g1) each one writes, as the kernel maps its blockIdx."""
        qt, sl = b % self.nqt, b // self.nqt
        return (qt * self.bq, torch.clamp((qt + 1) * self.bq, max=self.nq),
                sl * self.gps, torch.clamp((sl + 1) * self.gps, max=self.ngroups))


@dataclass(frozen=True)
class MmaPlan(SweepGrid):
    """The tile arithmetic of the tensor-core kernels for Q queries over N
    rows of d elements of ``itemsize`` bytes (2: bf16, 1: int8): phase 1
    runs ``grid`` blocks of ``bq`` queries and a slice of ``gps`` groups
    each, block b on query tile b % nqt and slice b // nqt, streaming each
    group's padded row in k-chunks of ``kc`` elements past a query tile kept
    in shared memory (``resident``) or streamed with them; the bf16 phase 2
    runs a block per (query, group) pair, whose warps stream ``rescore_kc``
    columns of their 32 rows at a time. Both double-buffer their copies.
    ``dp`` is d zero-padded to whole 32-byte k-steps (16 bf16 values, 32
    int8 codes). ``staged``: bytes per query of the tile that the sweep's
    output policy keeps in shared memory for the whole block (0 but for the
    two-level prototype's v2 layout), counted in ``smem``."""

    d: int
    dp: int
    kc: int
    resident: bool
    rescore_kc: int
    itemsize: int = 2
    staged: int = 0

    @property
    def smem(self) -> int:
        return (_groupmin_mma_smem(self.bq, self.nq, self.dp, self.kc, self.resident,
                                   self.itemsize) + self.bq * self.staged)

    @property
    def rescore_smem(self) -> int:
        rows = GROUP // _RESCORE_MMA_WARPS
        return 2 * (self.dp * 2 + _MMA_PAD_BYTES) + _RESCORE_MMA_WARPS * 2 * rows * (
            self.rescore_kc * 2 + _MMA_PAD_BYTES)

    def rescore_grid(self, t: int) -> int:
        """Phase-2 blocks for t candidate groups per query."""
        return self.nq * t


def mma_plan(nq: int, n: int, d: int, itemsize: int = 2, staged: int = 0,
             bq: int | None = None) -> MmaPlan:
    """The tile plan of the tensor-core sweep for Q = nq queries over an (n,
    d) store of ``itemsize``-byte elements (2: bf16, also the plan of the
    bf16 rescore; 1: int8), the one the wrappers launch with. bq is the
    smallest query tile that holds min(Q, 128) queries, or the ``bq`` of
    ``MMA_BQ`` given (``groupmin_variants.groupmin_tiled``). Two blocks should
    share an SM: the tile stays resident in shared memory if they still do,
    else it streams with the store if they then do (one block an SM only
    when neither does), with the widest k-chunk that allows it. The slice
    has as many groups as keep the grid near ``_MMA_TARGET_BLOCKS`` blocks,
    between 4 (and bq / 32) and 16. ``staged`` bytes per query that an
    output policy keeps for the block count with the rest before the k-chunk
    is chosen. Raises on shapes the kernels cannot take."""
    if nq < 1 or n < 1 or d < 1 or itemsize not in (1, 2):
        raise ValueError(f"no tile plan for Q={nq}, N={n}, d={d}, itemsize={itemsize}")
    step = _MMA_K_BYTES // itemsize
    dp = -(-d // step) * step
    kcs = sorted({min(dp, kc // itemsize) for kc in _MMA_KC_BYTES}, reverse=True)
    if bq is None:
        bq = next(b for b in MMA_BQ if b >= min(nq, MMA_BQ[-1]))
    elif bq not in MMA_BQ:
        raise ValueError(f"query tile bq={bq} not in {MMA_BQ}")
    nqt, ng = -(-nq // bq), num_groups(n)
    gps = min(ng, max(_MMA_MIN_SLICE, bq // 32,
                      min(_MMA_MAX_SLICE, ng * nqt // _MMA_TARGET_BLOCKS)))
    stage = bq * staged
    # a streamed tile's narrowest chunk fits at any d, so there is always one
    resident, kc = next((r, k) for limit in (_MMA_SMEM_TWO_BLOCKS, _SMEM_BYTES)
                        for r in (True, False)
                        for k in kcs
                        if _groupmin_mma_smem(bq, nq, dp, k, r, itemsize) + stage <= limit)
    plan = MmaPlan(nq=nq, n=n, bq=bq, gps=gps, d=d, dp=dp, kc=kc, resident=resident,
                   rescore_kc=min(dp, _RESCORE_MMA_KC), itemsize=itemsize, staged=staged)
    # the int8 phase 2 runs on CUDA cores (rescore_q8) and takes no plan
    if itemsize == 2 and plan.rescore_smem > _SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the bf16 rescore's shared-memory query row")
    if plan.grid > _GRID_MAX:
        raise ValueError(f"Q={nq} over N={n} rows exceeds the sweep's grid")
    return plan


#: queries per tile of the f32 warpgroup-MMA kernels (csrc/groupmin_tf32.cu)
_TF32_BQ = (16, 32, 64, 128)
_TF32_GROUP_ROWS_MAX = 2 ** 31 - 1 - GROUP  # their tensor maps take int row coordinates


def wgmma_plan(nq: int, n: int, sms: int) -> SweepGrid:
    """The f32 warpgroup-MMA sweep's blocks for Q = nq queries over n rows on
    a card of ``sms`` SMs: the smallest query tile of 16, 32, 64 or 128 that
    holds min(Q, 128) queries, and slices of as many groups as give about one
    block (its four-stage ring fills an SM) per SM. The f32 rescore runs on
    the same query tile (``bq``), so it repeats phase 1's products."""
    if nq < 1 or n < 1 or sms < 1:
        raise ValueError(f"no tile plan for Q={nq}, N={n} on {sms} SMs")
    bq = next(b for b in _TF32_BQ if b >= min(nq, _TF32_BQ[-1]))
    nqt = -(-nq // bq)
    ng = num_groups(n)
    grid = SweepGrid(nq, n, bq, min(ng, max(1, -(-ng * nqt // sms))))
    if grid.grid > _GRID_MAX:
        raise ValueError(f"Q={nq} over N={n} rows exceeds the sweep's grid")
    return grid


def _wgmma_rows(x: torch.Tensor) -> bool:
    """Whether the f32 store's rows suit the warpgroup-MMA kernels: d a
    multiple of 4 (16-byte rows), a 16-byte aligned base, int row indices."""
    return (x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
            and x.shape[0] <= _TF32_GROUP_ROWS_MAX)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of f32 values: (hi, lo) f32 with hi = tf32(v) and lo
    = tf32(v - hi), each rounded to nearest with ties away from zero (as
    ``cvt.rna.tf32.f32``: half a tf32 ulp added to the magnitude, the 13 low
    mantissa bits cleared), so each holds 10 explicit mantissa bits. v - hi
    is exact in f32, so hi + lo is v within 2^-22 |v| (finite v below
    2^128 - 2^114, where hi rounds to inf). The warpgroup-MMA kernels read
    their right operand split by this (the k-means centroids, the f32
    search's queries) and split their left one the same way in registers
    (``tf32_split`` in ``csrc/mma.cuh``)."""
    def rna(t: torch.Tensor) -> torch.Tensor:
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    v = v.float()
    hi = rna(v)
    return hi, rna(v - hi)


def _wgmma_plan(x: torch.Tensor, nq: int) -> SweepGrid:
    """:func:`wgmma_plan` for Q = nq queries over the store ``x`` on its card."""
    return wgmma_plan(nq, x.shape[0],
                      torch.cuda.get_device_properties(x.device).multi_processor_count)


def _vec_mma(q: torch.Tensor, x: torch.Tensor) -> int:
    """Elements per copy into shared memory: 16 bytes of them when the rows
    of both are 16-byte multiples at 16-byte aligned addresses, 4 bytes of
    them when they are 4-byte ones, else 1 (bf16: 8, 2 or 1; int8: 16, 4 or
    1)."""
    d, isz = x.shape[1], x.element_size()
    ptrs = (q.data_ptr(), x.data_ptr())
    for nbytes in (16, 4):
        vec = nbytes // isz
        if d % vec == 0 and all(p % nbytes == 0 for p in ptrs):
            return vec
    return 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_tensor_cores(x: torch.Tensor, nq: int) -> bool:
    """Whether :func:`groupmin` and :func:`rescore` score Q = nq queries
    against the f32 or bf16 store ``x`` on tensor cores: bf16 always, f32
    beyond ``F32_CUDA_CORE_MAX_Q`` queries over rows of whole 16-byte units
    (``_wgmma_rows``). One rule for both phases, so a group's phase-1 min is
    its phase-2 rows' min bit for bit."""
    return x.dtype == torch.bfloat16 or (nq > F32_CUDA_CORE_MAX_Q and _wgmma_rows(x))


# ---------------------------------------------------------------------------
# Phase 1: group mins
# ---------------------------------------------------------------------------


def groupmin(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Per query, the min of norms[r] - 2 q.x[r] over each 128-row group:
    (Q, ngroups) f32, query-major. Rows of the ragged last group past N
    count as +inf. ``q`` is already in the store dtype (and halved for ip).

    Replaces ``_groupmin_kernel`` (image_search_engine_tpu/ops/
    topk_pallas.py:252), a product on the TPU's matrix unit followed by
    128-column mins (f32 at ``Precision.HIGHEST``). Three kernels, all
    bounded by the 2*Q*N*d operations at large Q (three times that for f32,
    on the tf32 units) and by the store's bytes at small Q, none of which
    lets a score leave the chip:

    * bf16, on tensor cores (``groupmin_mma_kernel``): a block keeps a tile
      of up to 128 queries in shared memory and streams a slice of groups
      past it (``cp.async``, double-buffered, k-chunked for wide rows; where
      a resident tile of wide rows would leave an SM room for one block
      only, the tile streams with the store instead); warps multiply with
      ``mma.sync`` m16n8k16 and take each group's min in the epilogue. Q =
      1 takes the same route: its 16x unused products cost little next to
      reading the store. The tiles come from :func:`mma_plan`.
    * f32 beyond ``F32_CUDA_CORE_MAX_Q`` queries over rows of whole 16-byte
      units (``flat_tf32_kernel``, ``csrc/groupmin_tf32.cu``): the
      warpgroup MMA with a 3xTF32 split, store rows as its A operand (split
      once each in registers), the queries' halves (:func:`tf32_split`) as
      B; the Tensor Memory Accelerator streams 32-column stages of a group
      and up to 128 queries through a ring that one producer thread fills
      while two warpgroups multiply, about one block an SM
      (:func:`wgmma_plan`). Per 4 k-steps the products lo.hi, hi.lo, hi.hi
      of each step go into a zeroed sum, which one f32 add puts into the
      row's.
    * other f32 batches, on CUDA cores (``groupmin_kernel``, IEEE f32
      FMAs): up to ``F32_CUDA_CORE_MAX_Q`` queries its 2*Q*N*d flops are
      far below the f32 rate, so it is a memory-bandwidth kernel. It
      streams each row with 16-byte loads, keeps up to 8 queries in shared
      memory per block so one read of a row serves all of them, and orders
      blocks so the query tiles of one group run back to back and find the
      group in L2.

    None pads or copies the store: the kernels mask the ragged edge.
    """
    _check_scoring_args(q, x, norms)
    if not _on_cuda(q, x, norms):
        return groupmin_ref(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    out = torch.empty((nq, num_groups(n)), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    mma = _on_tensor_cores(x, nq)
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if mma and x.dtype == torch.bfloat16:
            p = mma_plan(nq, n, d)
            err = lib.ise_groupmin_mma(
                q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, p.bq,
                p.dp, p.kc, p.gps, int(p.resident), p.smem, _vec_mma(q, x), _stream(x))
        elif mma:
            hi, lo = tf32_split(q)
            p = _wgmma_plan(x, nq)
            err = lib.ise_groupmin_tf32(x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                        norms.data_ptr(), out.data_ptr(), nq, n, d, p.bq, p.gps,
                                        _stream(x))
        else:
            err = lib.ise_groupmin(q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(),
                                   nq, n, d, _query_tile(nq, d * 4), _vec(x), _stream(x))
    _kernels.check(err, "groupmin")
    groupmin.launches += 1
    groupmin.tensor_core_launches += int(mma)
    return out


groupmin.launches = 0
groupmin.tensor_core_launches = 0  # of those, the tensor-core sweep's


def groupmin_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin`: one f32 matmul, pad, group min."""
    n = x.shape[0]
    ng = num_groups(n)
    scores = norms[None, :] - 2.0 * (q.float() @ x.float().T)
    scores = F.pad(scores, (0, ng * GROUP - n), value=float("inf"))
    return scores.view(q.shape[0], ng, GROUP).amin(dim=2)


# ---------------------------------------------------------------------------
# int8 store: quantization and phase 1
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: (codes (N, d) int8, scales (N,)
    f32) with x ~= codes * scales[:, None]. The JAX package's formula, bit
    for bit: scale = max(amax, 1e-12) / 127 in f32, codes = clip(round(x /
    scale), -127, 127) with a true division and round half to even."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=1), min=1e-12)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale


def _epilogue_q8(cross: torch.Tensor, qscale: torch.Tensor, scales: torch.Tensor,
                 norms: torch.Tensor) -> torch.Tensor:
    """norms - cross * ((2 qscale) * scales), each step rounded once in f32,
    in the JAX kernels' order (the CUDA kernels round the same steps)."""
    return norms - cross * ((2.0 * qscale) * scales)


def groupmin_q8(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                scales: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Per query, the min over each 128-row group of norms[r] - f32(q.x[r])
    * ((2 qscale) * scales[r]), where q.x[r] is the exact int32 product of
    the int8 query and store codes: (Q, ngroups) f32, query-major. Rows of
    the ragged last group past N count as +inf. ``qscale`` is the query's
    dequant scale (halved for ip).

    Replaces ``_groupmin_kernel_q8`` (image_search_engine_tpu/ops/
    topk_pallas.py:276, launched :631), an int8 product on the TPU's matrix
    unit followed by 128-column mins. What bounds it on the card: the store,
    N*d code bytes plus 8 bytes of norm and scale per row, at serving batch
    sizes; the 2*Q*N*d integer operations at large Q (1,979 TOP/s on the
    int8 tensor cores). Two kernels, by batch size:

    * more than ``DP4A_MAX_Q`` queries, on tensor cores
      (``groupmin_mma_kernel`` in ``csrc/groupmin_mma.cuh``, the bf16
      sweep's template with int8 operands): ``mma.sync`` m16n8k32 into
      int32, query tiles of up to 128 queries against slices of groups
      streamed through shared memory (``cp.async``, double-buffered), d
      zero-padded to 32 codes, the tiles from ``mma_plan(..., itemsize=1)``;
      the epilogue converts each int32 sum with ``score_q8`` and takes the
      group mins, so no score leaves the chip;
    * up to ``DP4A_MAX_Q`` queries, on CUDA cores (``groupmin_q8_kernel``):
      only the store's bytes count there, and its warps stream whole rows
      with 16-byte loads, multiplying 4 codes at a time with ``__dp4a``,
      closer to the memory rate than the tile sweep's column slices.

    Integer sums are exact in any order and the zero padding adds 0, so the
    f32 epilogue, rounded step by step, is the only rounding: both kernels
    equal :func:`groupmin_q8_ref` bit for bit, and each group min is the
    min of its rows' :func:`rescore_q8` scores.
    """
    _check_q8_args(q, qscale, x, scales, norms)
    if not _on_cuda(q, qscale, x, scales, norms):
        return groupmin_q8_ref(q, qscale, x, scales, norms)
    nq, d = q.shape
    n = x.shape[0]
    out = torch.empty((nq, num_groups(n)), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if nq <= DP4A_MAX_Q:
            err = lib.ise_groupmin_q8(
                q.data_ptr(), qscale.data_ptr(), norms.data_ptr(), scales.data_ptr(),
                x.data_ptr(), out.data_ptr(), nq, n, d, _query_tile(nq, d), _vec_q8(q, x),
                _stream(x))
        else:
            p = mma_plan(nq, n, d, itemsize=1)
            err = lib.ise_groupmin_q8_mma(
                q.data_ptr(), qscale.data_ptr(), norms.data_ptr(), scales.data_ptr(),
                x.data_ptr(), out.data_ptr(), nq, n, d, p.bq, p.dp, p.kc, p.gps,
                int(p.resident), p.smem, _vec_mma(q, x), _stream(x))
    _kernels.check(err, "groupmin_q8")
    groupmin_q8.launches += 1
    return out


groupmin_q8.launches = 0


def _cross_q8(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 of the exact integer products q.x[r], (Q, N): a float64 matmul of
    the codes (exact below 2^53; an f32 one is not once 127^2 * d > 2^24),
    chunked over store rows."""
    qd = q.double()
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _Q8_REF_ROWS):
        out[:, s:s + _Q8_REF_ROWS] = (qd @ x[s:s + _Q8_REF_ROWS].double().T).float()
    return out


def groupmin_q8_ref(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                    scales: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin_q8`: exact product, f32 epilogue,
    pad, group min."""
    n = x.shape[0]
    ng = num_groups(n)
    scores = _epilogue_q8(_cross_q8(q, x), qscale[:, None], scales[None, :], norms[None, :])
    scores = F.pad(scores, (0, ng * GROUP - n), value=float("inf"))
    return scores.view(q.shape[0], ng, GROUP).amin(dim=2)


# ---------------------------------------------------------------------------
# Candidate select
# ---------------------------------------------------------------------------


#: the radix select (``csrc/select_topt.cu``) takes every t <= W: up to this
#: many selected entries it ranks each by counting the others (SEL_MAX_T,
#: entries in ``SelectShared``), ...
SELECT_RANK_MAX_T = 256
#: ... up to this many it sorts them by a bitonic network in shared memory
#: (SEL_BIG_T_MAX; pow2(t) 12-byte entries), larger t by a stable radix sort
#: in a global scratch of 2t 8-byte entries a row (t > _SELECT_MERGE_MAX, so
#: such rows are never split)
SELECT_SHARED_SORT_MAX_T = 4096
#: a row of a batch of at most a quarter as many queries as the card has
#: SMs is split over blocks of at least this many entries, ...
_SELECT_SPLIT_MIN_SLICE = 1024
#: ... at most this many blocks a row, ...
_SELECT_SPLIT_MAX = 16
#: ... whose split * t candidates the merging block stages (SEL_MERGE_MAX)
_SELECT_MERGE_MAX = 1024
#: slices of up to this many entries are staged in shared memory (48 KB;
#: SEL_STAGE_MAX), wider ones re-read through L1/L2
SELECT_STAGE_MAX = 12288
#: entries a block's sampled threshold may let through (SEL_CAND_MAX)
_SELECT_CAND_MAX = 1024
_SELECT_SAMPLE_MAX_STRIDE = 8  # the sample takes every stride-th entry, stride <= this


def select_sample_stride(n: int, t: int) -> int:
    """The radix select's sample stride over a block's n entries for t
    (``sample_stride`` in ``csrc/select_topt.cu``): the digit passes run
    over every stride-th entry, whose t-th (value, position) pair lets about
    stride * t entries of the n through, then over those. 1 (no sample)
    unless the sample holds at least 2t entries and stride * t is within
    half the ``_SELECT_CAND_MAX`` scratch."""
    st = min(_SELECT_SAMPLE_MAX_STRIDE, _SELECT_CAND_MAX // (2 * t))
    return st if st >= 2 and n // st >= 2 * t else 1


@dataclass(frozen=True)
class SelectPlan:
    """How :func:`select_topt` runs over (Q, W) mins: ``route`` "radix" (the
    one-pass select, ``csrc/select_topt.cu``, every plan of
    :func:`select_plan`) or "extract_min" (t passes, ``csrc/topk_twophase.cu``
    ``select_kernel``, a plan only ``chip_smoke.py`` builds, to time the
    kernel the radix select replaced); for "radix", each row split over
    ``split`` blocks of ``slice`` entries (the last may be shorter), whose
    candidates the row's last block to finish merges, and the t selected
    entries sorted by ``sort``: "rank" (counting), "bitonic" (shared
    memory) or "global" (a radix sort in a global scratch)."""

    route: str
    split: int
    slice: int
    sort: str = "rank"

    @property
    def staged(self) -> bool:
        """Whether a block stages its slice in shared memory."""
        return self.slice <= SELECT_STAGE_MAX


def select_sort(t: int) -> str:
    """How the radix select sorts the t entries it selected: "rank" up to
    ``SELECT_RANK_MAX_T``, "bitonic" up to ``SELECT_SHARED_SORT_MAX_T``,
    else "global"."""
    if t <= SELECT_RANK_MAX_T:
        return "rank"
    return "bitonic" if t <= SELECT_SHARED_SORT_MAX_T else "global"


def select_plan(nq: int, w: int, t: int, sms: int) -> SelectPlan:
    """:func:`select_topt`'s plan for Q = nq rows of w entries and t on a card
    of ``sms`` SMs: the radix select for every t, with each row split over
    as many blocks as put about one block on each SM (at most
    ``_SELECT_SPLIT_MAX``, slices of at least ``_SELECT_SPLIT_MIN_SLICE``
    entries, the merge's ``split * t`` candidates within
    ``_SELECT_MERGE_MAX``) when the batch has at most sms / 4 rows."""
    if nq < 1 or sms < 1 or not 0 < t <= w:
        raise ValueError(f"no select plan for Q={nq}, W={w}, t={t} on {sms} SMs")
    split = 1
    if 4 * nq <= sms:
        split = max(1, min(_SELECT_SPLIT_MAX, w // _SELECT_SPLIT_MIN_SLICE, sms // nq,
                           _SELECT_MERGE_MAX // t))
    slice_ = -(-w // split)
    return SelectPlan("radix", -(-w // slice_), slice_, select_sort(t))


#: per (device, stream): the split select's ticket counters, zero between
#: launches (the merging block of a row resets its counter)
_select_counters: dict = {}


def _counters(mins: torch.Tensor) -> torch.Tensor:
    """At least Q zeroed ticket counters for the split select of ``mins``."""
    key = (mins.device, _stream(mins))
    buf = _select_counters.get(key)
    if buf is None or buf.numel() < mins.shape[0]:
        buf = torch.zeros(max(mins.shape[0], 1024), dtype=torch.int32, device=mins.device)
        _select_counters[key] = buf
    return buf


def select_topt(mins: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, the t smallest entries of a (Q, W) row in ascending
    (value, position) order: (vals (Q, t) f32, ids (Q, t) int32). Ties go to
    the lowest position (-0.0 and +0.0 tie; each value keeps its own bits);
    vals[:, t-1] is the certificate threshold.

    Replaces ``_select_topt_kernel`` (topk_pallas.py:361, via
    ``_select_topt`` :392). What bounds it on the card: it reads the (Q, W)
    mins once, 1/(128*d) of the store (the bench point: 128 MB, 0.038 ms).
    The TPU kernel's t extract-min passes are serial, each a block-wide
    reduction (ported as ``select_kernel``, whose time is t passes' latency;
    no search path takes it). Instead a radix select (``csrc/select_topt.cu``)
    reads the row once into shared memory, finds the t-th (value, position)
    pair digit by digit (a bounded number of barriers, whatever t), then
    compacts the t entries at or below it and sorts only those: by counting
    up to ``SELECT_RANK_MAX_T`` (the t-th pair of a sample of the row bounds
    the entries the digit passes must see), by a bitonic network in shared
    memory up to ``SELECT_SHARED_SORT_MAX_T``, beyond by a stable radix sort
    in a global scratch that this wrapper allocates. 256-thread blocks let
    several queries share an SM, and a batch of a few rows splits each row
    over several blocks whose candidates the row's last block merges
    (:func:`select_plan`). Counts its launches in ``launches`` and per route
    in ``radix_launches`` and ``extract_min_launches``.
    """
    nq, ng = mins.shape
    if not 0 < t <= ng:
        raise ValueError(f"t={t} outside (0, ngroups={ng}]")
    if mins.dtype != torch.float32 or not mins.is_contiguous():
        raise ValueError("mins must be contiguous float32")
    if not _on_cuda(mins):
        return select_topt_ref(mins, t)
    vals = torch.empty((nq, t), dtype=torch.float32, device=mins.device)
    ids = torch.empty((nq, t), dtype=torch.int32, device=mins.device)
    if nq == 0:
        return vals, ids
    plan = select_plan(nq, ng, t, torch.cuda.get_device_properties(mins.device)
                       .multi_processor_count)
    with torch.cuda.device(mins.device):
        lib = _kernels.library()
        if plan.route == "extract_min":
            err = lib.ise_select_topt(mins.data_ptr(), vals.data_ptr(), ids.data_ptr(), nq, ng,
                                      t, _stream(mins))
        else:
            part_v = part_i = counters = sort_g = 0
            if plan.split > 1:  # the slices' candidates: values, then positions
                part = torch.empty(2 * nq * plan.split * t, dtype=torch.int32,
                                   device=mins.device)
                part_v, part_i = part.data_ptr(), part.data_ptr() + 4 * nq * plan.split * t
                counters = _counters(mins).data_ptr()
            if plan.sort == "global":  # the radix sort's two buffers of t pairs a row
                sort_scratch = torch.empty(2 * nq * t, dtype=torch.int64, device=mins.device)
                sort_g = sort_scratch.data_ptr()
            err = lib.ise_select_radix(mins.data_ptr(), vals.data_ptr(), ids.data_ptr(), part_v,
                                       part_i, counters, sort_g, nq, ng, t, plan.split,
                                       plan.slice, int(plan.staged), _stream(mins))
    _kernels.check(err, "select_topt")
    select_topt.launches += 1
    if plan.route == "extract_min":
        select_topt.extract_min_launches += 1
    else:
        select_topt.radix_launches += 1
    return vals, ids


select_topt.launches = 0
select_topt.radix_launches = 0  # of those, the radix select's (every plan of select_plan)
select_topt.extract_min_launches = 0  # and the extract-min kernel's (chip_smoke.py's comparison)


def select_topt_ref(mins: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`select_topt`: a stable ascending sort is the
    (value, position) order of both routes, ties included."""
    vals, ids = torch.sort(mins, dim=1, stable=True)
    return vals[:, :t].contiguous(), ids[:, :t].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Phase 2: candidate rescore
# ---------------------------------------------------------------------------


def rescore(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
            cand: torch.Tensor) -> torch.Tensor:
    """Scores norms[r] - 2 q.x[r] for every row r of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32; column j*128 + i
    is row cand[:, j]*128 + i. Rows past N score +inf.

    Replaces ``_fused_rescore_kernel`` (topk_pallas.py:298, launched at
    :775). What bounds it on the card: the gathered bytes, Q*t*128*d*
    itemsize, read from scattered 128-row blocks in place from the store
    (no (Q, t*128, d) gather buffer). The rows are scored by the routine of
    phase 1 for the same store dtype and batch size (``_on_tensor_cores``),
    so a group's phase-1 min is bit for bit the min of its phase-2 scores:

    * bf16 (``rescore_mma_kernel``): :func:`groupmin`'s tensor-core
      routine, a block per (query, group) pair, with the query in A row
      (query % 16) and each of the group's rows in the lane and register
      phase 1 gives it; each of the block's four warps streams 32 of the
      rows in k-chunks (``cp.async``, two stages per warp), so a pair keeps
      four chunks in flight.
    * f32 beyond ``F32_CUDA_CORE_MAX_Q`` queries over rows of whole 16-byte
      units (``flat_tf32_kernel``, ``csrc/groupmin_tf32.cu``): phase 1's
      kernel, a block per (query, group) pair, on the query tile phase 1
      gave the query (:func:`wgmma_plan`'s ``bq``), so every score comes
      from phase 1's instructions on phase 1's operands; the tile's other
      queries' products are discarded.
    * other f32 batches (``rescore_kernel``): each group split over 4
      blocks (32 rows, 4 per warp) to put more SMs on the gather at Q = 1,
      each row scored by ``row_dot`` as in phase 1.
    """
    _check_scoring_args(q, x, norms)
    _check_cand(cand, q.shape[0])
    if not _on_cuda(q, x, norms, cand):
        return rescore_ref(q, x, norms, cand)
    nq, d = q.shape
    t = cand.shape[1]
    mma = _on_tensor_cores(x, nq)
    if not mma and d * 4 > _SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory query row")
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0 or t == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if mma and x.dtype == torch.bfloat16:
            p = mma_plan(nq, x.shape[0], d)
            err = lib.ise_rescore_mma(
                q.data_ptr(), norms.data_ptr(), x.data_ptr(), cand.data_ptr(), out.data_ptr(), nq,
                x.shape[0], d, t, p.dp, p.rescore_kc, p.rescore_smem, _vec_mma(q, x),
                _stream(x))
        elif mma:
            hi, lo = tf32_split(q)
            err = lib.ise_rescore_tf32(x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                       norms.data_ptr(), cand.data_ptr(), out.data_ptr(), nq,
                                       x.shape[0], d, t, _wgmma_plan(x, nq).bq, _stream(x))
        else:
            err = lib.ise_rescore(q.data_ptr(), norms.data_ptr(), x.data_ptr(), cand.data_ptr(),
                                  out.data_ptr(), nq, x.shape[0], d, t, _vec(x), _stream(x))
    _kernels.check(err, "rescore")
    rescore.launches += 1
    rescore.tensor_core_launches += int(mma)
    return out


rescore.launches = 0
rescore.tensor_core_launches = 0  # of those, the tensor-core rescore's


def rescore_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore`: gather the candidate rows, batched
    f32 matmul."""
    nq, t = cand.shape
    valid, safe = _candidate_rows(cand, x.shape[0])
    xs = x[safe.reshape(-1)].float().view(nq, t * GROUP, x.shape[1])
    cross = torch.bmm(xs, q.float()[:, :, None])[:, :, 0]
    scores = norms[safe] - 2.0 * cross
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


def _candidate_rows(cand: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, safe) (Q, t*128): which candidate-group rows exist, and
    their row ids clamped into the store."""
    nq, t = cand.shape
    rows = (cand.long()[:, :, None] * GROUP
            + torch.arange(GROUP, device=cand.device)).reshape(nq, t * GROUP)
    return (rows >= 0) & (rows < n), rows.clamp(0, max(n - 1, 0))


def _check_cand(cand: torch.Tensor, nq: int) -> None:
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[0] != nq:
        raise ValueError("cand must be int32 of shape (Q, t)")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous")


#: rescore_q8 runs a batch's candidate slots in group order when they number
#: at least this many and at least half the store's groups: fewer share too
#: few groups to pay for the ordering (chip_smoke.py phase 4 times both
#: orders at Q = 1, 64 and 256; PERF.md)
RESCORE_Q8_GROUP_ORDER_MIN_SLOTS = 512


def rescore_q8_order(cand: torch.Tensor, ngroups: int) -> torch.Tensor | None:
    """The order in which :func:`rescore_q8` scores the (Q, t) candidate
    slots: :func:`group_order`, so that the queries that picked one group
    read it back to back, for a batch of at least
    ``RESCORE_Q8_GROUP_ORDER_MIN_SLOTS`` slots that number at least half the
    store's ``ngroups`` (many queries then share groups); else None (slot
    order)."""
    if cand.numel() < max(RESCORE_Q8_GROUP_ORDER_MIN_SLOTS, ngroups / 2):
        return None
    return group_order(cand, ngroups).order


class GroupOrder(NamedTuple):
    """:func:`group_order`'s result over ngroups groups, in bins: bin 0 ids
    below 0, bin g + 1 group g, bin ngroups + 1 ids of ngroups or more.
    ``order``: an int32 permutation of the flat slots, bins ascending;
    ``ends``: int32 (ngroups + 2,), each bin's end in ``order``; ``live``:
    int32 (ngroups + 3,), the number of bins that have slots, then their
    ids ascending (``ops/ivf.probed_scan``'s bucket route runs a block per
    such bin), the rest unset."""

    order: torch.Tensor
    ends: torch.Tensor
    live: torch.Tensor


def group_order(cand: torch.Tensor, ngroups: int) -> GroupOrder:
    """The flat (Q, t) candidate slots grouped by group id, groups ascending
    (ids below 0 first, ids of ``ngroups`` or more last), with each bin's
    end and the bins that have slots (:class:`GroupOrder`). On the card a
    one-block counting sort (``group_order_kernel``,
    ``csrc/topk_twophase_q8.cu``, whose offsets end as the bins' ends),
    which orders a group's slots in any way; on the CPU its plain version,
    a stable argsort. Counts its launches in ``group_order.launches``."""
    _check_cand(cand, cand.shape[0])
    if not _on_cuda(cand):
        return group_order_ref(cand, ngroups)
    order = torch.empty(cand.numel(), dtype=torch.int32, device=cand.device)
    ends = torch.empty(ngroups + 2, dtype=torch.int32, device=cand.device)
    live = torch.empty(ngroups + 3, dtype=torch.int32, device=cand.device)
    if cand.numel() == 0:
        return GroupOrder(order, ends.zero_(), live.zero_())
    with torch.cuda.device(cand.device):
        err = _kernels.library().ise_group_order(cand.data_ptr(), order.data_ptr(),
                                                 ends.data_ptr(), live.data_ptr(), cand.numel(),
                                                 ngroups, _stream(cand))
    _kernels.check(err, "group_order")
    group_order.launches += 1
    return GroupOrder(order, ends, live)


group_order.launches = 0


def group_order_ref(cand: torch.Tensor, ngroups: int) -> GroupOrder:
    """Plain version of :func:`group_order`: a stable argsort of the ids
    clamped to [-1, ngroups] (ties keep slot order); the bins' ends are the
    running sum of their counts; the live bins those of nonzero count (the
    unset rest of ``live`` is 0)."""
    bins = cand.reshape(-1).clamp(-1, ngroups).long() + 1
    order = torch.argsort(bins, stable=True).to(torch.int32)
    counts = torch.bincount(bins, minlength=ngroups + 2)
    nonzero = torch.nonzero(counts)[:, 0]
    live = torch.zeros(ngroups + 3, dtype=torch.int32)
    live[0], live[1:1 + nonzero.numel()] = nonzero.numel(), nonzero
    return GroupOrder(order, torch.cumsum(counts, 0).to(torch.int32), live.to(cand.device))


def rescore_q8(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
               norms: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """:func:`groupmin_q8`'s score for every row r of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32; column j*128 + i
    is row cand[:, j]*128 + i. Rows past N score +inf.

    Replaces ``_fused_rescore_kernel_q8`` (topk_pallas.py:333, launched at
    :756). What bounds it on the card: the distinct candidate groups' bytes,
    128*(d + 8) each, read from scattered 128-row blocks in place (no gather
    buffer); at Q = 1 that is a few dozen groups, and how many bytes are in
    flight sets the time. So each row gets its own warp, which reads the
    query's 16-byte chunks beside the row's from L2 (no staged query, no
    barrier) and issues all of its loads before the ``__dp4a`` chain; and a
    batch whose queries share groups runs its slots in group order
    (:func:`rescore_q8_order`), so the queries that picked one group read
    it back to back, from L2 after the first. Each row's int32 sum is exact
    and its epilogue :func:`groupmin_q8`'s, so a group's phase-1 min is bit
    for bit the min of its phase-2 scores, in any order.
    """
    _check_q8_args(q, qscale, x, scales, norms)
    _check_cand(cand, q.shape[0])
    if not _on_cuda(q, qscale, x, scales, norms, cand):
        return rescore_q8_ref(q, qscale, x, scales, norms, cand)
    nq, d = q.shape
    t = cand.shape[1]
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0 or t == 0:
        return out
    with torch.cuda.device(x.device):
        order = rescore_q8_order(cand, num_groups(x.shape[0]))
        err = _kernels.library().ise_rescore_q8(
            q.data_ptr(), qscale.data_ptr(), norms.data_ptr(), scales.data_ptr(), x.data_ptr(),
            cand.data_ptr(), 0 if order is None else order.data_ptr(), out.data_ptr(), nq,
            x.shape[0], d, t, _vec_q8(q, x), _stream(x))
    _kernels.check(err, "rescore_q8")
    rescore_q8.launches += 1
    return out


rescore_q8.launches = 0


def rescore_q8_ref(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
                   norms: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_q8`: per query, gather the candidate
    rows, exact float64 product, f32 epilogue."""
    valid, safe = _candidate_rows(cand, x.shape[0])
    cross = torch.empty(safe.shape, dtype=torch.float32, device=x.device)
    for i in range(q.shape[0]):
        cross[i] = (x[safe[i]].double() @ q[i].double()).float()
    scores = _epilogue_q8(cross, qscale[:, None], scales[safe], norms[safe])
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


# ---------------------------------------------------------------------------
# Running-accumulator exact top-k
# ---------------------------------------------------------------------------

#: neighbours the running and merged top-k kernels return at most (as the
#: TPU kernels)
KERNEL_MAX_K = 128
#: scan blocks the replaced running top-k kernel aims for per SM (a few
#: waves, long slices)
_RUNNING_BLOCKS_PER_SM = 8
#: warps per scan block of either kernel (``WARPS`` in csrc/scoring.cuh,
#: ``ROWS_WARPS`` in csrc/topk_running_rows.cu: the consumers)
_RUNNING_WARPS = 8
#: the running top-k's routes: "staged", rows staged in shared memory by the
#: Tensor Memory Accelerator and scored a lane per row
#: (csrc/topk_running_rows.cu, every caller's), and "row_dot", the warp per
#: row kernel it replaced (csrc/topk_running.cu, ``chip_smoke.py``'s
#: comparison only)
RUNNING_ROUTES = ("staged", "row_dot")
#: the route :func:`topk_running` launches on CUDA tensors; ``chip_smoke.py``
#: alone sets it to "row_dot", for the length of a comparison
RUNNING_ROUTE = "staged"
# The staged kernel's shared memory (csrc/topk_running_rows.cu): a stage is
# 256 rows (a lane each) x 128 bytes of them, after 128 bytes of mbarriers
# and 1024 of alignment; the f32 query tile is qt rows of d rounded up to a
# stage's columns.
_ROWS_TILE = 256
_ROWS_SPAN = 128
_ROWS_STAGE = _ROWS_TILE * _ROWS_SPAN
_ROWS_MAX_STAGES = 8
_ROWS_FIXED = 2 * _ROWS_MAX_STAGES * 8 + 1024
#: shared memory of an H100 SM (228 KB), each resident block reserving 1 KB,
#: and the most one block may ask for (227 KB)
_SM_SMEM = 233_472
_BLOCK_SMEM_MAX = 232_448


def _running_slices(n: int, k: int, nqt: int, sms: int) -> int:
    """Store slices per query tile of the replaced ("row_dot") kernel:
    enough blocks for a few waves over the SMs, but at least k rows for each
    warp of a slice, so the slices' lists stay small next to the store."""
    want = -(-_RUNNING_BLOCKS_PER_SM * sms // nqt)
    return max(1, min(want, n // (_RUNNING_WARPS * k)))


@dataclass(frozen=True)
class RunningPlan:
    """The staged running top-k's launch for Q = nq queries over an (n, d)
    store of ``itemsize``-byte elements at k neighbours: blocks of
    ``qt`` queries and a slice of ``rows_per_slice`` rows (whole 256-row
    tiles), ``nslices`` slices per query tile, a ring of ``stages`` stages of
    32 KB, ``blocks_per_sm`` blocks sharing an SM; ``smem`` bytes of dynamic
    shared memory a block (the ring and the f32 query tile, or the warps'
    lists where those are larger)."""

    nq: int
    n: int
    d: int
    itemsize: int
    k: int
    qt: int
    stages: int
    blocks_per_sm: int
    nslices: int
    rows_per_slice: int

    @property
    def nqt(self) -> int:
        return -(-self.nq // self.qt)

    @property
    def dpad(self) -> int:
        span = _ROWS_SPAN // self.itemsize
        return -(-self.d // span) * span

    @property
    def smem(self) -> int:
        return _rows_smem(self.qt, self.dpad, self.stages, self.k)


def _rows_smem(qt: int, dpad: int, stages: int, k: int) -> int:
    """running_rows_smem in csrc/topk_running_rows.cu."""
    return _ROWS_FIXED + max(stages * _ROWS_STAGE + qt * dpad * 4,
                             _RUNNING_WARPS * qt * k * 8)


def running_plan(nq: int, n: int, d: int, itemsize: int, k: int, sms: int) -> RunningPlan:
    """The launch of the staged running top-k (csrc/topk_running_rows.cu) on
    a card of ``sms`` SMs. The query tile holds min(Q, 8) queries (a power
    of two), halved until it and a ring of two stages fit a block. Two
    blocks share an SM where the tile leaves them a ring of two stages each
    and holds at most 4 queries (the kernel's register budget for two
    blocks), else one does, with a ring of as many stages (up to 8) as fit.
    The slices give every SM its blocks in one wave, as long as each warp of
    a slice gets k rows, in whole 256-row tiles. Raises on shapes the kernel
    cannot take."""
    if nq < 1 or n < 1 or d < 1 or itemsize not in (2, 4) or not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"no running plan for Q={nq}, N={n}, d={d}, itemsize={itemsize}, k={k}")
    span = _ROWS_SPAN // itemsize
    dpad = -(-d // span) * span
    qt = next(t for t in (1, 2, 4, 8) if t >= min(nq, 8))
    while qt > 1 and _rows_smem(qt, dpad, 2, k) > _BLOCK_SMEM_MAX:
        qt //= 2
    if _rows_smem(qt, dpad, 2, k) > _BLOCK_SMEM_MAX:
        raise ValueError(f"a {d * 4}-byte query row leaves no room for the running top-k's ring")
    for bps in (2, 1) if qt <= 4 else (1,):
        budget = min(_BLOCK_SMEM_MAX, _SM_SMEM // bps - 1024)
        stages = min(_ROWS_MAX_STAGES, (budget - _ROWS_FIXED - qt * dpad * 4) // _ROWS_STAGE)
        if stages >= 2 and _rows_smem(qt, dpad, stages, k) <= budget:
            break
    nqt = -(-nq // qt)
    nslices = max(1, min(bps * sms // nqt, n // (_RUNNING_WARPS * k)))
    rows = -(-n // nslices)
    rows_per_slice = -(-rows // _ROWS_TILE) * _ROWS_TILE
    return RunningPlan(nq=nq, n=n, d=d, itemsize=itemsize, k=k, qt=qt, stages=stages,
                       blocks_per_sm=bps, nslices=-(-n // rows_per_slice),
                       rows_per_slice=rows_per_slice)


def _running_route() -> str:
    if RUNNING_ROUTE not in RUNNING_ROUTES:
        raise ValueError(f"RUNNING_ROUTE={RUNNING_ROUTE!r} not in {RUNNING_ROUTES}")
    return RUNNING_ROUTE


def topk_running(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by one pass over the store with running top-k
    accumulators: (distances (Q, k) f32, ids (Q, k) int64), ascending for
    l2, descending for ip and cosine; ties go to the lowest id. When k > N
    the tail is (+inf, -1) for l2 and (-inf, -1) for ip and cosine.

    Counterpart of the JAX package's ``topk_pallas``. ``x`` is an f32 or
    bf16 store; the query stays f32 over either (the products are f32,
    bf16 rows widened exactly), unlike :func:`topk_twophase`, which casts it
    to the store dtype. ``x_norms`` as in :func:`topk_twophase` (ip keeps
    only their PAD_NORM poisoning). k <= 128.

    Replaces ``_topk_kernel`` (image_search_engine_tpu/ops/topk_pallas.py:
    79, launched :211). What bounds it on the card: one read of the store
    per query tile of up to 8 queries, N*d*itemsize + 4N bytes, so at
    serving batch sizes a memory-bandwidth kernel like :func:`groupmin`.
    The design (``csrc/topk_running_rows.cu``, :func:`running_plan`) splits
    the store into slices, one block per (slice, query tile); a producer
    warp streams the slice into a ring of shared-memory stages with the
    Tensor Memory Accelerator, and each lane of 8 consumer warps sums one
    row for every query of the tile, the query values read as broadcasts;
    per query, a ballot against the warp's k-th picks the rows that enter
    the warp's own sorted top-k (the TPU kernel's reject-fast test); the
    block merges its warps' lists, and a second kernel merges the slices'
    lists per query. On the "row_dot" route (:data:`RUNNING_ROUTE`), the
    warp-per-row kernel it replaced. Launches are counted in
    ``topk_running.launches`` and per route in ``<route>_launches``.
    """
    qf, x, norms, metric, q = _running_inputs(q, x, k, metric, x_norms)
    if not _on_cuda(qf, x, norms):
        vals, ids = _running_ref_core(qf, x, norms, k)
        return _finish_scores(vals, ids, q, metric)
    nq, d = qf.shape
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"N={n} rows: the running top-k kernel takes N < 2^31")
    route = _running_route()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if route == "staged":
        plan = running_plan(max(nq, 1), max(n, 1), d, x.element_size(), k, sms)
        qt, nslices = plan.qt, plan.nslices
    else:
        qt = _query_tile(nq, d * 4)
        nslices = _running_slices(n, k, -(-nq // qt), sms)
    nqt = -(-nq // qt)
    if nqt > 65535:
        raise ValueError(f"{nq} queries exceed the kernel's grid ({65535 * qt} at most)")
    vals = torch.empty((nq, k), dtype=torch.float32, device=x.device)
    ids = torch.empty((nq, k), dtype=torch.int32, device=x.device)
    if nq == 0:
        return _finish_scores(vals, ids.long(), q, metric)
    part_v = torch.empty((nq, nslices, k), dtype=torch.float32, device=x.device)
    part_i = torch.empty((nq, nslices, k), dtype=torch.int32, device=x.device)
    args = (_DTYPE_CODES[x.dtype], qf.data_ptr(), norms.data_ptr(), x.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), nq, n, d, k,
            qt, nslices)
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if route == "staged":
            err = lib.ise_topk_running_rows(*args, plan.rows_per_slice, plan.stages, plan.smem,
                                            int(_vec(x) > 1), _stream(x))
        else:
            err = lib.ise_topk_running(*args, _vec(x), _stream(x))
    _kernels.check(err, "topk_running")
    topk_running.launches += 1
    setattr(topk_running, f"{route}_launches", getattr(topk_running, f"{route}_launches") + 1)
    return _finish_scores(vals, ids.long(), q, metric)


topk_running.launches = 0
topk_running.staged_launches = 0  # of those, the staged kernel's
topk_running.row_dot_launches = 0  # and the warp-per-row kernel's (chip_smoke.py's comparison)


def topk_running_ref(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_running`, on any device: an f32 matmul
    and a stable sort on (score, id)."""
    qf, x, norms, metric, q = _running_inputs(q, x, k, metric, x_norms)
    vals, ids = _running_ref_core(qf, x, norms, k)
    return _finish_scores(vals, ids, q, metric)


def _running_inputs(q, x, k, metric, x_norms):
    """(f32 query as scored, store, norms, metric, query for the l2 norm):
    the TPU wrapper's preparation (cosine normalizes both sides, ip halves
    the query and keeps only the PAD_NORM poisoning of the norms)."""
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"k={k} outside [1, {KERNEL_MAX_K}] for the running top-k kernel")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32 or bfloat16, got {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    q, x, metric = _cosine_as_ip(q, x, metric)
    qf = q.float()
    if metric == "ip":
        qf = qf * 0.5
    return qf.contiguous(), x.contiguous(), _search_norms(x, metric, x_norms), metric, q


def _running_ref_core(qf, x, norms, k):
    """The k smallest of norms - 2 q.x per query in (score, id) order, padded
    with (+inf, -1) past N: (vals f32, ids int64)."""
    n = x.shape[0]
    scores = norms[None, :] - 2.0 * (qf @ x.float().T)
    vals, ids = torch.sort(scores, dim=1, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    if k > n:
        vals = F.pad(vals, (0, k - n), value=float("inf"))
        ids = F.pad(ids, (0, k - n), value=-1)
    return vals.contiguous(), ids.contiguous()


KERNELS = (groupmin, select_topt, rescore, groupmin_q8, rescore_q8, topk_running)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    groupmin.tensor_core_launches = rescore.tensor_core_launches = 0
    topk_running.staged_launches = topk_running.row_dot_launches = 0
    select_topt.radix_launches = select_topt.extract_min_launches = 0
    group_order.launches = 0  # rescore_q8's slot order (counted apart from KERNELS)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _cosine_as_ip(q: torch.Tensor, x: torch.Tensor, metric: str):
    """(q, x, metric) with cosine turned into ip over rows normalized in f32
    (the store rounded back to its dtype); raises on other metrics."""
    if metric == "cosine":
        q = l2_normalize(q.float())
        x = l2_normalize(x.float()).to(x.dtype)
        metric = "ip"
    if metric not in ("l2", "ip"):
        raise ValueError(f"unsupported metric {metric!r}")
    return q, x, metric


def _search_norms(x: torch.Tensor, metric: str, x_norms: torch.Tensor | None,
                  x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The per-row norms the kernels score with, f32 (N,): l2 the squared
    store norms (``x_norms``, or computed; an int8 store's dequantized
    ones), ip zeros except PAD_NORM on the rows ``x_norms`` poisons."""
    if metric == "l2":
        if x_norms is not None:
            norms = x_norms
        elif x_scale is not None:  # the dequantized store's norms
            deq = x.float() * x_scale[:, None]
            norms = (deq * deq).sum(1)
        else:
            norms = (x.float() * x.float()).sum(1)
    else:
        norms = (torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
                 if x_norms is None else ip_penalty(x_norms))
    return norms.to(torch.float32).contiguous()


def _finish_scores(vals: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                   metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores in the minimize domain -> distances in the metric's sign: l2
    adds the f32 query's squared norm (clamped at 0), ip negates."""
    if metric == "l2":
        qnorm = (q.float() * q.float()).sum(1, keepdim=True)
        return torch.clamp(vals + qnorm, min=0.0), ids
    return 0.0 - vals, ids  # ip: scores are penalty - q.x; a zero score gives +0.0, not -0.0


def finish_candidates(q: torch.Tensor, scores: torch.Tensor, cand: torch.Tensor,
                      threshold: torch.Tensor, k: int, metric: str,
                      with_certificate: bool) -> Tuple[torch.Tensor, ...]:
    """The two-phase searches' last step: the k best of the (Q, t*128)
    rescored candidates, their row ids rebuilt from the (Q, t) group ids,
    the distances in the metric's sign, and with ``with_certificate`` the
    certificate "k-th score <= threshold" (the t-th selected group min;
    at k = 0, where the JAX package's ``topk_twophase`` raises, vacuously
    true: no kept score exceeds it)."""
    nq, t = cand.shape
    kk = min(k, t * GROUP)
    # positions follow the select's group order, so ties go to the earlier
    # selected group, then the lower row: the JAX package's lax.top_k ids
    vals, pos = stable_smallest(scores, kk)
    flat_ids = (cand.long()[:, :, None] * GROUP
                + torch.arange(GROUP, device=scores.device)).reshape(nq, t * GROUP)
    ids = torch.gather(flat_ids, 1, pos)
    extra = ((vals <= threshold[:, None]).all(dim=1),) if with_certificate else ()
    return _finish_scores(vals, ids, q, metric) + extra


def topk_twophase(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    t_margin: int = 4,
    with_certificate: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Exact k-NN via group-min sweep + candidate rescore. Same contract as
    ``ops.distances.topk_flat``: (distances (Q, k), ids (Q, k) int64),
    ascending for l2, descending for ip/cosine; with ``with_certificate``
    a third output, bool (Q,), True where the result is provably exact.

    ``x`` is an f32, bf16 or int8 store (N, d); an int8 store needs its
    per-row dequant scales ``x_scale`` (N,), and the query is then quantized
    per row the same way, so the result is exact over the quantized store
    and quantized query (l2 adds the unquantized query's squared norm).
    ``x_norms`` are the store's squared norms, PAD_NORM on padding rows
    (index/store.py), computed from x when absent (l2) or taken as zeros
    (ip). t = min(k + t_margin, ngroups); when t == ngroups every group is
    rescored and the select does not run.
    """
    is_int8 = x.dtype == torch.int8
    if is_int8 and x_scale is None:
        raise ValueError("int8 store requires x_scale")
    if not is_int8 and x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32, bfloat16 or int8, got {x.dtype}")
    if metric == "cosine" and is_int8:
        raise ValueError("pre-normalize rows and use metric='ip' with int8")
    q, x, metric = _cosine_as_ip(q, x, metric)
    nq = q.shape[0]
    ng = num_groups(x.shape[0])
    if is_int8:
        qf, qscale = quantize_int8(q)
        x_scale = x_scale.to(torch.float32).contiguous()
    else:
        qf = q.to(x.dtype).contiguous()
    norms = _search_norms(x, metric, x_norms, x_scale if is_int8 else None)
    if metric == "ip":
        if is_int8:
            qscale = qscale * 0.5  # the epilogue multiplies by 2 * qscale
        else:
            qf = qf * 0.5

    if is_int8:
        mins = groupmin_q8(qf, qscale, x, x_scale, norms)
    else:
        mins = groupmin(qf, x, norms)
    t = min(k + t_margin, ng)
    if t < ng:
        sel_vals, cand = select_topt(mins, t)
        threshold = sel_vals[:, t - 1]
    else:  # every group is a candidate: nothing pruned, certificate trivially True
        cand = torch.arange(ng, dtype=torch.int32, device=x.device).expand(nq, ng).contiguous()
        threshold = torch.full((nq,), float("inf"), device=x.device)
    if is_int8:
        scores = rescore_q8(qf, qscale, x, x_scale, norms, cand)
    else:
        scores = rescore(qf, x, norms, cand)

    return finish_candidates(q, scores, cand, threshold, k, metric, with_certificate)


def topk_twophase_safe(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    t_margin: int = 4,
    wide_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_twophase`` with the certificate enforced: if any query's
    certificate fails, the whole call re-runs once at ``wide_margin`` and
    logs; a failure there too is logged as an error, never looped on."""
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms, x_scale=x_scale,
                               t_margin=t_margin, with_certificate=True)
    if bool(cert.all()):
        return d, i
    log.warning(
        "top-k exactness certificate failed for %d/%d queries at margin %d; "
        "re-running at margin %d",
        int((~cert).sum()), cert.shape[0], t_margin, wide_margin)
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms, x_scale=x_scale,
                               t_margin=wide_margin, with_certificate=True)
    if not bool(cert.all()):
        log.error("certificate still failing at margin %d (%d queries)",
                  wide_margin, int((~cert).sum()))
    return d, i
