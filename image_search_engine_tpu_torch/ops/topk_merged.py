"""Merged single-launch two-phase exact top-k.

Port of ``image_search_engine_tpu/ops/topk_merged.py``: the group-min
sweep, the candidate select and the candidate rescore of
:func:`~image_search_engine_tpu_torch.ops.topk.topk_twophase` in one
persistent launch (``csrc/topk_merged.cu``), then the same stable candidate
sort, id rebuild and certificate as the two-phase search. f32 and bf16
stores, l2, ip and cosine, k <= 128, no escalation: with
``with_certificate`` the caller sees which queries are proved exact.

The launch runs the two-phase search's own kernels' routines, on the route
``ops/topk._on_tensor_cores`` picks for both of that search's phases (bf16:
the ``mma.sync`` sweep and rescore; f32 beyond ``F32_CUDA_CORE_MAX_Q``
queries over rows of whole 16-byte units: the warpgroup 3xTF32 sweep and
rescore; other f32 batches: ``row_dot`` on CUDA cores), and the radix
select on every route, so on the card it equals ``topk_twophase(...,
t_margin=t_margin)`` bit for bit: mins, candidates, threshold, scores,
distances, ids and certificates. Query blocks are pipelined: one block's
select and rescore run under the next block's sweep (:func:`merged_plan`).
On the CPU both run the same plain versions. The JAX package counts t =
min(k + t_margin, ngroups) over a store padded to its tile, so the two
packages agree whenever k + t_margin <= ceil(N / 128), the real group count
the port uses; below that the port rescores every real group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _DTYPE_CODES,
    _SMEM_BYTES,
    _TF32_GROUP_ROWS_MAX,
    _check_scoring_args,
    _cosine_as_ip,
    _on_cuda,
    _query_tile,
    _search_norms,
    _stream,
    _vec,
    _vec_mma,
    F32_CUDA_CORE_MAX_Q,
    GROUP,
    KERNEL_MAX_K,
    SELECT_RANK_MAX_T,
    SELECT_SHARED_SORT_MAX_T,
    finish_candidates,
    groupmin_ref,
    mma_plan,
    num_groups,
    rescore_ref,
    select_topt_ref,
    tf32_split,
    wgmma_plan,
)

#: queries a unit sweeps the store with, at least (the last unit may have
#: fewer): the JAX kernel's query block (``qb_rows``). More units read the
#: store more often; fewer leave a longer select and rescore that no sweep
#: runs under.
MERGED_UNIT_QUERIES = 512
#: blocks an SM holds at once on CUDA cores, as the kernel's launch bounds
#: promise the compiler (256 threads; on ``mma.sync`` two, the sweep's, on
#: the warpgroup MMA one, whose ring fills an SM)
_MERGED_CUDA_BLOCKS = 4
_SM_SMEM = 228 * 1024  # shared memory of an H100 SM ...
_BLOCK_SMEM_RESERVED = 1024  # ... of which each resident block takes 1 KB more
# the select's shared state (SelectShared, 5304 bytes, rounded to 16) and
# its candidate scratch (SEL_CAND_BYTES) in csrc/select_radix.cuh
_SELECT_SHARED_BYTES = 5312
_SELECT_CAND_BYTES = 1024 * 12 + 16
_SELECT_SORT_GLOBAL_BYTES = 8 * 256 * 4  # per-warp digit counts of the global sort
# the bf16 rescore (csrc/twophase.cuh rescore_mma_smem): two staged query
# rows, then two stages of 32 rows a warp over four warps
_RESCORE_MMA_KCS = (128, 64, 32, 16)
_PAD = 16
# the f32 warpgroup-MMA layout (csrc/groupmin_tf32.cuh Tf32Layout)
_TF32_STAGES = 4
_TF32_A_BYTES = GROUP * 32 * 4

ROUTES = ("cuda", "mma", "tf32")
SWEEP, SELECT, RESCORE = "sweep", "select", "rescore"
SCHEDULE_KINDS = (SWEEP, SELECT, RESCORE)


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def _select_smem(t: int) -> int:
    """Shared-memory bytes of a select item for t (``merged_select_smem`` in
    the kernel): the select's state, the candidate scratch, and the sort's
    room beyond t = 256. The row itself is read from L2."""
    if t <= SELECT_RANK_MAX_T:
        sort = 0
    elif t <= SELECT_SHARED_SORT_MAX_T:
        sort = (1 << (t - 1).bit_length()) * 12
    else:
        sort = _SELECT_SORT_GLOBAL_BYTES
    return _SELECT_SHARED_BYTES + _SELECT_CAND_BYTES + sort


def _rescore_mma_smem(dp: int, kc: int) -> int:
    return 2 * (dp * 2 + _PAD) + 4 * 2 * (GROUP // 4) * (kc * 2 + _PAD)


def _tf32_stage(bq: int) -> int:
    return _TF32_A_BYTES + 2 * bq * 32 * 4


def _tf32_smem(bq: int) -> int:
    return 1024 + _TF32_STAGES * _tf32_stage(bq) + 2 * 8 * bq * 4 + 2 * _TF32_STAGES * 8


def _smem_for_blocks(blocks: int) -> int:
    """The most shared memory a block may take with ``blocks`` blocks an SM."""
    return min(_SMEM_BYTES, _SM_SMEM // blocks - _BLOCK_SMEM_RESERVED)


@dataclass(frozen=True)
class MergedPlan:
    """One launch of :func:`merged_candidates` for Q = nq queries over an
    (n, d) store and t candidate groups a query, as ``csrc/topk_merged.cu``
    runs it.

    ``route``: "mma" (bf16, ``mma_plan``'s tile: ``bq``, ``gps``, ``dp``,
    ``kc``, ``resident``; ``rescore_kc`` the rescore's k-chunk), "tf32" (f32
    on the warpgroup MMA, ``wgmma_plan``'s ``bq`` and ``gps``) or "cuda"
    (f32 on CUDA cores, ``bq`` queries a sweep item, one group each). A
    unit is ``tiles_per_unit`` query tiles of ``bq`` queries. The work items
    are dispensed in the order of :meth:`phases`: the sweep of unit 0, the
    sweep of unit 1, the select of unit 0, the rescore of unit 0, the sweep
    of unit 2, ... A unit's sweep items are the sweep
    kernel's blocks of its tiles, slice-major (item j: tile j % tiles, slice
    j // tiles, the kernel's block slice * nqt + tile); its select items
    its queries; its rescore items its (query, group) slots in order, four
    items a slot on CUDA cores (32 rows each), two slots an item on "mma",
    one on "tf32". ``grid`` blocks (``blocks_per_sm`` on each of ``sms``)
    of ``smem`` bytes of dynamic shared memory, the most any item needs."""

    route: str
    nq: int
    n: int
    d: int
    t: int
    bq: int
    gps: int
    tiles_per_unit: int
    smem: int
    blocks_per_sm: int
    sms: int
    dp: int = 0
    kc: int = 0
    resident: bool = False
    rescore_kc: int = 0

    @property
    def ngroups(self) -> int:
        return num_groups(self.n)

    @property
    def nqt(self) -> int:
        return -(-self.nq // self.bq)

    @property
    def nslices(self) -> int:
        """Sweep items per query tile."""
        return -(-self.ngroups // self.gps)

    @property
    def units(self) -> int:
        return -(-self.nqt // self.tiles_per_unit)

    @property
    def grid(self) -> int:
        return self.sms * self.blocks_per_sm

    def unit_tiles(self, u: int) -> Tuple[int, int]:
        """The query tiles [lo, hi) of unit u."""
        lo = u * self.tiles_per_unit
        return lo, min(self.nqt, lo + self.tiles_per_unit)

    def unit_queries(self, u: int) -> Tuple[int, int]:
        """The queries [lo, hi) of unit u."""
        lo, hi = self.unit_tiles(u)
        return lo * self.bq, min(self.nq, hi * self.bq)

    def items(self, kind: str, u: int) -> int:
        """How many items of ``kind`` unit u has."""
        lo, hi = self.unit_tiles(u)
        if kind == SWEEP:
            return self.nslices * (hi - lo)
        q0, q1 = self.unit_queries(u)
        if kind == SELECT:
            return q1 - q0
        slots = (q1 - q0) * self.t
        return {"cuda": 4 * slots, "mma": -(-slots // 2), "tf32": slots}[self.route]

    def phases(self) -> List[Tuple[str, int]]:
        """The phases (kind, unit) in the order the kernel's ``next_item``
        dispenses their items: the sweeps of units 0 and 1, the select and
        rescore of unit 0, the sweep of unit 2, the select and rescore of
        unit 1, ..."""
        out = []
        for step in range(self.units + 1):
            if step < self.units:
                out.append((SWEEP, step))
            if step:
                out += [(SELECT, step - 1), (RESCORE, step - 1)]
        return out

    @property
    def total_items(self) -> int:
        return sum(self.items(kind, u) for kind, u in self.phases())

    def _index(self, kind: str, u: int, j):
        """The kernel's index of item j (an int or an array) of ``kind`` in
        unit u: a sweep item's the sweep kernel's block, a select item's its
        query, a rescore item's its first slot (on CUDA cores, the rescore
        kernel's block)."""
        lo, hi = self.unit_tiles(u)
        if kind == SWEEP:
            return (j // (hi - lo)) * self.nqt + lo + j % (hi - lo)
        q0 = self.unit_queries(u)[0]
        if kind == SELECT:
            return q0 + j
        if self.route == "cuda":
            return q0 * self.t * 4 + j
        return q0 * self.t + (2 if self.route == "mma" else 1) * j

    def schedule(self):
        """Every item in ticket order, as the kernel's ``next_item`` maps
        tickets: numpy arrays (kind, unit, index), kind the position in
        ``SCHEDULE_KINDS``, index as :meth:`_index`."""
        import numpy as np

        kinds, units, index = [], [], []
        for kind, u in self.phases():
            j = np.arange(self.items(kind, u), dtype=np.int64)
            kinds.append(np.full(len(j), SCHEDULE_KINDS.index(kind)))
            units.append(np.full(len(j), u))
            index.append(self._index(kind, u, j))
        return tuple(np.concatenate(a) for a in (kinds, units, index))


def merged_plan(nq: int, n: int, d: int, dtype: torch.dtype, sms: int, t: int, *,
                units: int | None = None, aligned: bool = True) -> MergedPlan:
    """The plan of :func:`merged_candidates` for Q = nq queries over an (n,
    d) store of ``dtype`` and t candidate groups a query, on a card of
    ``sms`` SMs; ``aligned``: the store starts at a 16-byte boundary.

    The route is the two-phase search's (``ops/topk._on_tensor_cores``):
    bf16 "mma", f32 beyond ``F32_CUDA_CORE_MAX_Q`` queries over rows of
    whole 16-byte units "tf32", other f32 "cuda"; the sweep's query tile and
    slice are that route's kernel's (``mma_plan``, ``wgmma_plan``,
    ``_query_tile``). A unit is as many query tiles as hold
    ``MERGED_UNIT_QUERIES`` queries (one unit for a batch of at most that
    many), or the tiles split into ``units`` units. Shared memory: the most
    any item takes, the bf16 rescore's k-chunk (its two pairs) the widest
    that keeps the sweep's blocks an SM (the select reads its row from L2;
    on the f32 warpgroup route it works in the ring); the grid fills every
    SM with as many blocks as fit. Raises on shapes the kernel cannot
    take.
    """
    if nq < 1 or n < 1 or d < 1 or sms < 1:
        raise ValueError(f"no merged plan for Q={nq}, N={n}, d={d} on {sms} SMs")
    ng = num_groups(n)
    if not 0 < t <= ng:
        raise ValueError(f"t={t} outside (0, ngroups={ng}]")
    if dtype == torch.bfloat16:
        route = "mma"
    elif dtype == torch.float32:
        tc = nq > F32_CUDA_CORE_MAX_Q and d % 4 == 0 and aligned and n <= _TF32_GROUP_ROWS_MAX
        route = "tf32" if tc else "cuda"
    else:
        raise ValueError(f"store dtype must be float32 or bfloat16, got {dtype}")
    fields = {}
    if route == "mma":
        mp = mma_plan(nq, n, d)
        bq, gps, sweep = mp.bq, mp.gps, mp.smem
        blocks = 2 if sweep <= _smem_for_blocks(2) else 1
        limit = _smem_for_blocks(blocks)
        rkc = next((kc for kc in _RESCORE_MMA_KCS if kc <= mp.rescore_kc
                    and 2 * _round16(_rescore_mma_smem(mp.dp, kc)) <= limit), None)
        if rkc is None:
            raise ValueError(f"d={d} exceeds the merged bf16 rescore's shared memory")
        base = max(sweep, 2 * _round16(_rescore_mma_smem(mp.dp, rkc)))
        fields = dict(dp=mp.dp, kc=mp.kc, resident=mp.resident, rescore_kc=rkc)
    elif route == "tf32":
        wp = wgmma_plan(nq, n, sms)
        bq, gps = wp.bq, wp.gps
        blocks, base = 1, _tf32_smem(bq)
        limit = _TF32_STAGES * _tf32_stage(bq)  # the select works in the ring
    else:
        bq, gps = _query_tile(nq, d * 4), 1
        sweep = bq * d * 4
        blocks = _MERGED_CUDA_BLOCKS
        while blocks > 1 and sweep > _smem_for_blocks(blocks):
            blocks -= 1
        limit, base = _smem_for_blocks(blocks), sweep
    select = _select_smem(t)
    if route == "tf32":
        if select > limit:
            raise ValueError(f"t={t} exceeds the merged select's shared memory")
        smem = base
    else:
        smem = max(base, select)
        blocks = min(blocks, max(1, _SM_SMEM // (smem + _BLOCK_SMEM_RESERVED)))
    nqt = -(-nq // bq)
    if units is None:
        tpu = min(nqt, -(-MERGED_UNIT_QUERIES // bq))
    elif units >= 1:
        tpu = -(-nqt // units)
    else:
        raise ValueError(f"units={units} < 1")
    plan = MergedPlan(route=route, nq=nq, n=n, d=d, t=t, bq=bq, gps=gps, tiles_per_unit=tpu,
                      smem=smem, blocks_per_sm=blocks, sms=sms, **fields)
    if plan.total_items + plan.grid > 2 ** 31 - 1:
        raise ValueError(f"Q={nq} over N={n} rows exceeds the merged kernel's tickets")
    return plan


def merged_candidates(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor, t: int, *,
                      units: int | None = None) -> Tuple[torch.Tensor, ...]:
    """The two-phase search's three steps in one launch: (scores (Q, t*128)
    f32, cand (Q, t) int32, threshold (Q,) f32, mins (Q, ngroups) f32).
    ``mins`` are the per-128-row group mins of norms - 2 q.x; ``cand`` the t
    groups with the smallest mins in ascending (value, group id) order, or
    every group in order when t = ngroups; ``threshold`` the t-th selected
    min (+inf when t = ngroups); ``scores`` every row of the candidate
    groups, column j*128 + i for row cand[:, j]*128 + i, +inf past N. ``q``
    is already in the store dtype (and halved for ip). ``units`` overrides
    the plan's unit count (:func:`merged_plan`), to measure what the
    pipelining buys.

    Replaces ``_merged_kernel`` (image_search_engine_tpu/ops/topk_merged.py:
    66, launched :337). What bounds it on the card: what bounds the
    two-phase search, one read of the store per unit (bytes at serving batch
    sizes, the sweep's operations at large Q) and then the candidate rows.
    The design: one persistent launch whose blocks take the two-phase
    kernels' work items from a global ticket, a unit's select and rescore
    dispensed after the next unit's sweep so that they run under it, each
    waiting on the items whose outputs it reads (``csrc/topk_merged.cu``).
    Every item runs the kernel's own routine, so the outputs are
    ``groupmin``'s, ``select_topt``'s and ``rescore``'s bit for bit. It
    raises, and never falls back to three launches, if the card refuses the
    launch. Counts its launches in ``launches``, and those on tensor cores
    in ``tensor_core_launches``.
    """
    _check_scoring_args(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    ng = num_groups(n)
    if not 0 < t <= ng:
        raise ValueError(f"t={t} outside (0, ngroups={ng}]")
    if not _on_cuda(q, x, norms):
        return merged_candidates_ref(q, x, norms, t)
    dev = x.device
    scores = torch.empty((nq, t * GROUP), dtype=torch.float32, device=dev)
    cand = torch.empty((nq, t), dtype=torch.int32, device=dev)
    threshold = torch.empty((nq,), dtype=torch.float32, device=dev)
    mins = torch.empty((nq, ng), dtype=torch.float32, device=dev)
    if nq == 0:
        return scores, cand, threshold, mins
    plan = merged_plan(nq, n, d, x.dtype,
                       torch.cuda.get_device_properties(dev).multi_processor_count, t,
                       units=units, aligned=x.data_ptr() % 16 == 0)
    vals = torch.empty((nq, t), dtype=torch.float32, device=dev)  # the selected mins
    counters = torch.zeros(1 + plan.units + nq, dtype=torch.int32, device=dev)
    sort_g = (torch.empty(2 * nq * t, dtype=torch.int64, device=dev)
              if t > SELECT_SHARED_SORT_MAX_T else None)
    qhi = qlo = None
    if plan.route == "tf32":
        qhi, qlo = tf32_split(q)
    vec = {"cuda": _vec(x), "mma": _vec_mma(q, x), "tf32": 0}[plan.route]
    with torch.cuda.device(dev):
        lib = _kernels.library()
        entry = lib.ise_topk_merged_tf32 if plan.route == "tf32" else lib.ise_topk_merged
        err = entry(
            ROUTES.index(plan.route), q.data_ptr(), 0 if qhi is None else qhi.data_ptr(),
            0 if qlo is None else qlo.data_ptr(), norms.data_ptr(), x.data_ptr(),
            mins.data_ptr(), cand.data_ptr(), threshold.data_ptr(), scores.data_ptr(),
            vals.data_ptr(), 0 if sort_g is None else sort_g.data_ptr(), counters.data_ptr(),
            nq, n, d, t, plan.bq, plan.gps, plan.tiles_per_unit, plan.dp, plan.kc,
            plan.rescore_kc, int(plan.resident), vec, plan.grid, plan.smem, _stream(x))
    _kernels.check(err, "topk_merged")
    merged_candidates.launches += 1
    merged_candidates.tensor_core_launches += int(plan.route != "cuda")
    return scores, cand, threshold, mins


merged_candidates.launches = 0
merged_candidates.tensor_core_launches = 0  # of those, on tensor cores ("mma", "tf32")


def merged_candidates_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                          t: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`merged_candidates`: the two-phase search's
    three plain versions in sequence."""
    mins = groupmin_ref(q, x, norms)
    nq, ng = mins.shape
    if t < ng:
        vals, cand = select_topt_ref(mins, t)
        threshold = vals[:, t - 1].contiguous()
    else:
        cand = torch.arange(ng, dtype=torch.int32, device=x.device).expand(nq, ng).contiguous()
        threshold = torch.full((nq,), float("inf"), device=x.device)
    return rescore_ref(q, x, norms, cand), cand, threshold, mins


def topk_merged(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    t_margin: int = 2,
    with_certificate: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Exact k-NN by the merged two-phase search. Same contract as
    ``topk_twophase``: (distances (Q, k), ids (Q, k) int64), ascending for
    l2, descending for ip and cosine, and with ``with_certificate`` a bool
    (Q,) that is True where the result is provably exact. ``x`` is an f32
    or bf16 store (int8 raises: use ``topk_twophase``); the query is cast to
    the store dtype and halved for ip. t = min(k + t_margin, ceil(N /
    128)); note the margin's default, 2, as in the JAX package (the
    two-phase search's is 4).
    """
    if x.dtype == torch.int8:
        raise ValueError("topk_merged: int8 stores are not supported (use topk_twophase)")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"k={k} outside [1, {KERNEL_MAX_K}] for the merged kernel")
    q, x, metric = _cosine_as_ip(q, x, metric)
    qf = q.to(x.dtype).contiguous()
    if metric == "ip":
        qf = qf * 0.5
    norms = _search_norms(x, metric, x_norms)
    t = min(k + t_margin, num_groups(x.shape[0]))
    scores, cand, threshold, _ = merged_candidates(qf, x, norms, t)
    return finish_candidates(q, scores, cand, threshold, k, metric, with_certificate)
