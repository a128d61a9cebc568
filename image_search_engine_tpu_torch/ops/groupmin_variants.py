"""The phase-1 group-min sweep's prototype variants (``csrc/groupmin_width_mma.cu``,
``csrc/groupmin_two_level_mma.cu``, ``csrc/groupmin_chunked_wgmma.cu``,
``csrc/groupmin_variants.cu``).

Ports of the TPU prototypes under the JAX repo's ``benchmarks/``, each the
production sweep (:func:`~image_search_engine_tpu_torch.ops.topk.groupmin`:
the min of norms - 2 q.x over groups of store rows) with one thing changed:

  * :func:`groupmin_width`: the group width G in {128, 64, 32}
    (``rescore_variants2.py``);
  * :func:`groupmin_two_level`: the 128-row group mins and, from the same
    sweep, the 32-row subgroup mins rounded to bf16, in three output layouts
    (``subgroup_proto.py``, ``subgroup_variants.py``);
  * :func:`groupmin_chunked`: each 4096-row tile's product done 512 or 1024
    rows at a time, each chunk's mins before the next (``sweep_chunked.py``);
  * :func:`groupmin_tiled`: the production sweep itself on a query tile the
    caller picks (``twophase_breakdown.py``'s 2-D grid).

The width and two-level kernels are production's bf16 tensor-core sweep
(``csrc/groupmin_mma.cuh``, on :func:`~image_search_engine_tpu_torch.ops.
topk.mma_plan`'s tiles) with another output policy in its epilogue, so
what each changes is all that separates its time from ``groupmin``'s, and
their 128-row mins are ``groupmin``'s bit for bit. The chunked kernel is a
bf16 sweep on the warpgroup MMA fed by the Tensor Memory Accelerator
(``csrc/groupmin_wgmma.cuh``, on :func:`chunked_plan`'s tiles), whose two
consumer warpgroups take the products in turn so that one's mins overlap
the other's product. The CUDA-core kernels they replaced (a warp per row
scored by ``row_dot``, the design production ``groupmin`` ran for bf16
before its tensor cores; for the chunked one, register-blocked f32 FMAs)
stay as the ``cuda_core`` route, which only ``chip_smoke.py`` takes,
through :data:`ROUTE`.

As in the prototypes, the query and the store are bf16 (f32 sums) and the
mins are group-major, (groups, Q), but for :func:`groupmin_tiled`'s, which
are ``groupmin``'s (Q, ngroups). Rows of a ragged last group past N count
as +inf; nothing is padded. Each wrapper launches its CUDA kernel for CUDA
tensors (or raises) and runs its plain PyTorch version (``*_ref``: one f32
product, then mins over slices) for CPU tensors, and counts its launches in
``<wrapper>.launches``, and per route in ``mma_launches`` and
``cuda_core_launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (_BLOCK_SMEM_MAX, GROUP, MMA_BQ, MmaPlan,
                                                    SweepGrid, _on_cuda, _query_tile, _stream,
                                                    _vec_mma, groupmin_ref, mma_plan, num_groups)

SUB = 32  # subgroup width of the two-level sweep
WIDTHS = (128, 64, 32)
LAYOUTS = ("v1", "v2", "v3")
CHUNKS = (512, 1024)
#: the kernels' routes: "mma", the tensor-core sweeps (every caller), and
#: "cuda_core", the CUDA-core kernels they replaced (``chip_smoke.py``'s
#: comparison only)
ROUTES = ("mma", "cuda_core")
#: the route the wrappers launch on CUDA tensors; ``chip_smoke.py`` alone
#: sets it to "cuda_core", for the length of a comparison
ROUTE = "mma"
#: bytes per query that v2 stages in shared memory: a run of 8 groups'
#: bf16 subgroup mins (TwoLevelMins::RUN in csrc/groupmin_mma.cuh)
V2_STAGED = 8 * (GROUP // SUB) * 2
#: store rows per product in the plain versions (a multiple of every width;
#: bounds the (Q, rows) f32 score block)
_REF_ROWS = 1 << 16


def _check(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> None:
    if q.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"want a bf16 query and store, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (x.shape[0],):
        raise ValueError("norms must be float32 of shape (N,)")
    for name, t in (("q", q), ("x", x), ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned(*ts: torch.Tensor) -> bool:
    """Rows of 16-byte multiples at 16-byte aligned addresses (8 bf16 a
    load). The CUDA-core width and two-level kernels load only store rows
    this way (queries are staged one element at a time), so they pick the
    same row routine as each other for the same store."""
    return all(t.shape[1] % 8 == 0 and t.data_ptr() % 16 == 0 for t in ts)


def _route() -> str:
    if ROUTE not in ROUTES:
        raise ValueError(f"ROUTE={ROUTE!r} not in {ROUTES}")
    return ROUTE


def _count(fn, route: str) -> None:
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)


def two_level_plan(nq: int, n: int, d: int, layout: str) -> MmaPlan:
    """The tile plan :func:`groupmin_two_level` launches with: the sweep's
    (:func:`~image_search_engine_tpu_torch.ops.topk.mma_plan`), with v2's
    staging counted in its shared memory."""
    return mma_plan(nq, n, d, staged=V2_STAGED if layout == "v2" else 0)


def _group_mins(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                width: int) -> torch.Tensor:
    """(Q, ceil(N/width)) mins of norms - 2 q.x over width-row slices, from
    one f32 product per block of store rows; +inf past N."""
    n = x.shape[0]
    qf = q.float()
    out = []
    for s in range(0, n, _REF_ROWS):
        xs = x[s:s + _REF_ROWS]
        scores = norms[None, s:s + xs.shape[0]] - 2.0 * (qf @ xs.float().T)
        pad = -xs.shape[0] % width
        scores = F.pad(scores, (0, pad), value=float("inf"))
        out.append(scores.view(q.shape[0], -1, width).amin(dim=2))
    if not out:
        return torch.empty((q.shape[0], 0), dtype=torch.float32, device=x.device)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Row 10: the group width
# ---------------------------------------------------------------------------


def groupmin_width(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                   group: int) -> torch.Tensor:
    """Per query, the min of norms[r] - 2 q.x[r] over each ``group``-row
    group (128, 64 or 32): (ceil(N/group), Q) f32, group-major.

    Replaces ``groupmin_kernel`` (benchmarks/rescore_variants2.py:61,
    launched :86). What bounds it on the card: at large Q the 2*Q*N*d
    products. The kernel is ``groupmin``'s bf16 tensor-core sweep on the
    same tile plan, whose epilogue takes the min over the warps that hold a
    ``group``-row group (a warp holds 16 or 32 contiguous rows) and writes
    it group-major; at 128 the mins are ``groupmin(...).T`` bit for bit.
    On the ``cuda_core`` route (:data:`ROUTE`), the row_dot kernel it
    replaced: a warp per row, up to 8 queries staged per block, blocks of
    one group back to back.
    """
    _check(q, x, norms)
    if group not in WIDTHS:
        raise ValueError(f"group={group} not in {WIDTHS}")
    if not _on_cuda(q, x, norms):
        return groupmin_width_ref(q, x, norms, group)
    nq, d = q.shape
    n = x.shape[0]
    out = torch.empty((-(-n // group), nq), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    route = _route()
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if route == "mma":
            p = mma_plan(nq, n, d)
            err = lib.ise_groupmin_width_mma(
                q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, group,
                p.bq, p.dp, p.kc, p.gps, int(p.resident), p.smem, _vec_mma(q, x), _stream(x))
        else:
            err = lib.ise_groupmin_width(
                q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, group,
                _query_tile(nq, d * 4), 8 if _aligned(x) else 1, _stream(x))
    _kernels.check(err, "groupmin_width")
    _count(groupmin_width, route)
    return out


groupmin_width.launches = 0
groupmin_width.mma_launches = 0  # of those, the tensor-core sweep's
groupmin_width.cuda_core_launches = 0  # and the row_dot kernel's (chip_smoke.py's comparison)


def groupmin_width_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                       group: int) -> torch.Tensor:
    """Plain version of :func:`groupmin_width`: an f32 product, then mins."""
    return _group_mins(q, x, norms, group).T.contiguous()


# ---------------------------------------------------------------------------
# Rows 12 and 13: group and subgroup mins
# ---------------------------------------------------------------------------


def groupmin_two_level(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                       layout: str = "v1") -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep, two outputs: (group mins (ngroups, Q) f32, subgroup mins
    (Q, nsub) bf16), over 128-row groups and 32-row subgroups (nsub =
    ceil(N/32)). A subgroup min is the f32 min rounded to nearest even bf16,
    as ``.to(torch.bfloat16)``; a group min is the min of its four subgroup
    mins in f32.

    ``layout`` is how the subgroup mins leave the kernel, the TPU
    prototypes' three: "v1" query-major, written as each group ends; "v2"
    query-major, staged in shared memory for a run of 8 groups and written
    as each query's run of 32; "v3" subgroup-major (nsub, Q), then
    transposed here.

    Replaces ``_kernel_two_level`` (benchmarks/subgroup_proto.py:39,
    launched :77; "v1") and ``_kernel`` (benchmarks/subgroup_variants.py:36,
    launched :85; all three). What bounds it on the card: the 2*Q*N*d
    products at large Q. The kernel is ``groupmin``'s bf16 tensor-core
    sweep (:func:`two_level_plan`), whose epilogue writes the group mins
    and each subgroup's, the min over the one or two warps that hold it;
    the group mins are ``groupmin(...).T`` bit for bit. On the
    ``cuda_core`` route (:data:`ROUTE`), the row_dot kernel it replaced,
    each warp keeping four subgroup mins per query in registers.
    """
    _check(q, x, norms)
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} not in {LAYOUTS}")
    if not _on_cuda(q, x, norms):
        return groupmin_two_level_ref(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    nsub = -(-n // SUB)
    gmin = torch.empty((-(-n // GROUP), nq), dtype=torch.float32, device=x.device)
    sshape = (nsub, nq) if layout == "v3" else (nq, nsub)
    smin = torch.empty(sshape, dtype=torch.bfloat16, device=x.device)
    if nq and n:
        route = _route()
        with torch.cuda.device(x.device):
            lib = _kernels.library()
            if route == "mma":
                p = two_level_plan(nq, n, d, layout)
                err = lib.ise_groupmin_two_level_mma(
                    q.data_ptr(), norms.data_ptr(), x.data_ptr(), gmin.data_ptr(),
                    smin.data_ptr(), nq, n, d, LAYOUTS.index(layout), p.bq, p.dp, p.kc, p.gps,
                    int(p.resident), p.smem, _vec_mma(q, x), _stream(x))
            else:
                err = lib.ise_groupmin_two_level(
                    q.data_ptr(), norms.data_ptr(), x.data_ptr(), gmin.data_ptr(),
                    smin.data_ptr(), nq, n, d, LAYOUTS.index(layout), _query_tile(nq, d * 4),
                    8 if _aligned(x) else 1, _stream(x))
        _kernels.check(err, "groupmin_two_level")
        _count(groupmin_two_level, route)
    return gmin, (smin.T.contiguous() if layout == "v3" else smin)


groupmin_two_level.launches = 0
groupmin_two_level.mma_launches = 0  # of those, the tensor-core sweep's
groupmin_two_level.cuda_core_launches = 0  # and the row_dot kernel's (chip_smoke.py's comparison)


def groupmin_two_level_ref(q: torch.Tensor, x: torch.Tensor,
                           norms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`groupmin_two_level` (every layout gives the
    same tensors): an f32 product, 32-row mins, then mins of four."""
    sub = _group_mins(q, x, norms, SUB)
    pad = -sub.shape[1] % (GROUP // SUB)
    grp = F.pad(sub, (0, pad), value=float("inf")).view(q.shape[0], -1, GROUP // SUB).amin(2)
    return grp.T.contiguous(), sub.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Row 11: chunked columns
# ---------------------------------------------------------------------------


#: queries per tile of the chunked warpgroup-MMA sweep: 64 or 128 per
#: consumer warpgroup (csrc/groupmin_wgmma.cuh, BQ = 128 MT)
CHUNKED_BQ = (128, 256)
_WG_SPAN = 64  # bf16 columns of one 128-byte swizzle span (WG_SPAN)
_WG_X_SPAN = GROUP * 128  # a group's rows over one span, in bytes (WG_X_SPAN)


@dataclass(frozen=True)
class ChunkedPlan(SweepGrid):
    """The chunked warpgroup-MMA sweep's tiles for Q = nq queries over an
    (n, d) bf16 store: block b takes query tile b % nqt (``bq`` queries) and
    the slice of ``gps`` groups b // nqt; a group's rows arrive over ``nkc``
    ring stages of ``kc`` columns each (d zero-padded to ``dp``), in a ring
    of ``stages`` stages; the query tile stays in shared memory for the
    block (``resident``) or arrives in each stage beside the rows."""

    d: int
    kc: int
    stages: int
    resident: bool

    @property
    def dp(self) -> int:
        return -(-self.d // self.kc) * self.kc

    @property
    def nkc(self) -> int:
        return self.dp // self.kc

    @property
    def stage_bytes(self) -> int:
        """groupmin_wgmma_stage: the group's rows over kc columns, and the
        query tile's unless resident."""
        spans = self.kc // _WG_SPAN
        return spans * _WG_X_SPAN + (0 if self.resident else spans * self.bq * 128)

    @property
    def smem(self) -> int:
        """groupmin_wgmma_smem: alignment, resident tile, ring, mbarriers."""
        return (1024 + (self.bq * self.dp * 2 if self.resident else 0)
                + self.stages * self.stage_bytes + (2 * self.stages + 1) * 8)

    @property
    def rows_in_flight(self) -> int:
        """Store rows the ring holds: what ``chunk`` sets on the card."""
        return self.stages * GROUP // self.nkc


def chunked_plan(nq: int, n: int, d: int, chunk: int, sms: int) -> ChunkedPlan:
    """The tile plan :func:`groupmin_chunked` launches with on a card of
    ``sms`` SMs. Query tiles of 128 queries up to Q = 128, else 256 (two
    consumer warpgroups of one or two 64-query M tiles). A stage is a
    group's 128 rows over 128 columns (64 where d <= 64), so at d = 128 a
    group is one stage and one commit. The query tile is resident if it
    fits beside two stages, else it streams in every stage. ``chunk`` is
    the rows the ring keeps in flight: chunk / 128 groups' stages, as many
    as fit the 227 KB of shared memory a block may have (a warpgroup's
    product between two of its epilogues is one group whatever the chunk,
    its 128 queries x 128 rows of f32 sums filling 128 registers a thread).
    The slices give the SMs one wave of blocks, each query tile's blocks
    on one slice running together, so the slice is read from L2 after its
    first tile. Raises on shapes the kernel cannot take."""
    if nq < 1 or n < 1 or d < 8 or d % 8 or sms < 1 or chunk not in CHUNKS:
        raise ValueError(f"no chunked plan for Q={nq}, N={n}, d={d}, chunk={chunk} on {sms} SMs")
    if n > 2 ** 31 - 1 - GROUP:
        raise ValueError(f"N={n} rows exceed the tensor map's int row coordinates")
    bq = CHUNKED_BQ[0] if nq <= CHUNKED_BQ[0] else CHUNKED_BQ[1]
    kc = 2 * _WG_SPAN if d > _WG_SPAN else _WG_SPAN
    nqt, ng = -(-nq // bq), num_groups(n)
    nslices = min(ng, max(1, sms // nqt))
    gps = -(-ng // nslices)
    for resident in (True, False):
        base = ChunkedPlan(nq=nq, n=n, bq=bq, gps=gps, d=d, kc=kc, stages=0, resident=resident)
        fit = (_BLOCK_SMEM_MAX - base.smem) // (base.stage_bytes + 16)
        if fit >= 2:
            break
    want = chunk // GROUP * base.nkc
    return ChunkedPlan(nq=nq, n=n, bq=bq, gps=gps, d=d, kc=kc, stages=max(2, min(want, fit)),
                       resident=resident)


def groupmin_chunked(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """The 128-row group mins, (ngroups, Q) f32 group-major, of a sweep
    whose products and mins overlap: the same function as
    ``groupmin(...).T``, its sums in another order. ``chunk`` (512 or 1024,
    the TPU prototype's rows per product) sets the rows the sweep keeps in
    flight (:func:`chunked_plan`).

    Replaces ``chunked_kernel`` (benchmarks/sweep_chunked.py:53, launched
    :74). What bounds it on the card: the 2*Q*N*d products. The TPU
    script asked whether the matrix unit's product of the next chunk
    overlaps the vector unit's mins of this one; the kernel
    (``csrc/groupmin_chunked_wgmma.cu`` on ``csrc/groupmin_wgmma.cuh``) runs
    the products as asynchronous bf16 warpgroup MMAs fed by the Tensor
    Memory Accelerator, and its two consumer warpgroups take them in turn,
    so one's mins of a group run on the CUDA cores while the other's product
    runs on the tensor cores. Rows must be 16-byte multiples at 16-byte
    aligned addresses (d % 8 == 0). On the ``cuda_core`` route
    (:data:`ROUTE`), the kernel it replaced: a tile of 32768 / ``chunk``
    queries by ``chunk`` rows at a time, each thread an 8-query x 16-row
    register tile of f32 FMAs, the scores through shared memory to a min
    pass, then the next chunk.
    """
    _check(q, x, norms)
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk} not in {CHUNKS}")
    if not _on_cuda(q, x, norms):
        return groupmin_chunked_ref(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    if not _aligned(q, x):
        raise ValueError("groupmin_chunked takes rows of 16-byte multiples at aligned addresses")
    out = torch.empty((-(-n // GROUP), nq), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    route = _route()
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if route == "mma":
            p = chunked_plan(nq, n, d, chunk,
                             torch.cuda.get_device_properties(x.device).multi_processor_count)
            err = lib.ise_groupmin_chunked_wgmma(
                q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, p.bq,
                p.kc, p.stages, p.gps, int(p.resident), p.smem, _stream(x))
        else:
            err = lib.ise_groupmin_chunked(q.data_ptr(), norms.data_ptr(), x.data_ptr(),
                                           out.data_ptr(), nq, n, d, chunk, _stream(x))
    _kernels.check(err, "groupmin_chunked")
    _count(groupmin_chunked, route)
    return out


groupmin_chunked.launches = 0
groupmin_chunked.mma_launches = 0  # of those, the warpgroup-MMA sweep's
groupmin_chunked.cuda_core_launches = 0  # and the FMA kernel's (chip_smoke.py's comparison)


def groupmin_chunked_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin_chunked` (every chunk gives the same
    function): an f32 product, then 128-row mins."""
    return groupmin_width_ref(q, x, norms, GROUP)


# ---------------------------------------------------------------------------
# twophase_breakdown.py: production's sweep on a chosen query tile
# ---------------------------------------------------------------------------


def groupmin_tiled(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                   bq: int) -> torch.Tensor:
    """``groupmin``'s bf16 sweep with ``bq`` (one of ``MMA_BQ``: 16, 32, 64,
    128) queries a block, where production takes the smallest tile that
    holds min(Q, 128): the same (Q, ngroups) f32 mins, query-major.

    Replaces ``phase1_2d`` (benchmarks/twophase_breakdown.py:126), the
    production ``_groupmin_kernel`` on a 2-D grid of row tiles outer and
    256- or 512-query blocks inner. What bounds it on the card: the 2*Q*N*d
    products, as ``groupmin``. The kernel is ``groupmin``'s own
    (``groupmin_mma_kernel`` in ``csrc/groupmin_mma.cuh``, output policy
    ``QueryMajorMins``) on ``mma_plan(..., bq=bq)``: block b takes query
    tile b % nqt and slice b // nqt, so the query tiles of a slice run back
    to back and find it in L2, the TPU variant's order. A tile changes which
    warp holds a (query, row) sum and how the copies are staged, not the
    order of a sum's k-steps, so the mins are ``groupmin``'s bit for bit.
    The sweep's tile stops at 128 queries: the TPU's 256 and 512 are VMEM
    blocks, and its 1-D grid (every query in one block) has no counterpart.
    Counts its launches in ``groupmin_tiled.launches``; raises for a tile
    the kernel does not take.
    """
    _check(q, x, norms)
    if bq not in MMA_BQ:
        raise ValueError(f"query tile bq={bq} not in {MMA_BQ}")
    if not _on_cuda(q, x, norms):
        return groupmin_tiled_ref(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    out = torch.empty((nq, num_groups(n)), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        p = mma_plan(nq, n, d, bq=bq)
        err = _kernels.library().ise_groupmin_mma(
            q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, p.bq, p.dp,
            p.kc, p.gps, int(p.resident), p.smem, _vec_mma(q, x), _stream(x))
    _kernels.check(err, "groupmin_tiled")
    groupmin_tiled.launches += 1
    return out


groupmin_tiled.launches = 0


def groupmin_tiled_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin_tiled` (every tile gives the same
    function): ``groupmin``'s, an f32 product, then 128-row mins."""
    return groupmin_ref(q, x, norms)


KERNELS = (groupmin_width, groupmin_two_level, groupmin_chunked)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        for route in ROUTES:
            setattr(fn, f"{route}_launches", 0)
    groupmin_tiled.launches = 0  # one route: production's sweep
