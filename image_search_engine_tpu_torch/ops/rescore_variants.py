"""The phase-2 candidate rescore's prototype variants (``csrc/rescore_variants.cu``).

Ports of the TPU prototypes under the JAX repo's ``benchmarks/``, each the
production rescore (:func:`~image_search_engine_tpu_torch.ops.topk.rescore`:
every row of each query's candidate 128-row groups scored against it) with
one thing changed:

  * :func:`rescore_gather`: the rows' squared norms come from the gathered
    bf16 rows themselves, not from a norms array (``gather_kernel_proto.py``,
    ``gather_kernel_sweep2.py``);
  * :func:`rescore_cross`: only the raw cross products q.x leave the kernel;
    the caller adds the norms (``rescore_dma_variants.py``).

As in the prototypes, the query and the store are bf16 (f32 sums), and the
output is (Q, t*128) f32, column j*128 + r for row cand[:, j]*128 + r. Rows
past N score +inf (gather) or 0 (cross); nothing is padded. Each wrapper
launches its CUDA kernel for CUDA tensors (or raises) and runs its plain
PyTorch version (``*_ref``: a gather, then an f32 batched product) for CPU
tensors, and counts its launches in ``<wrapper>.launches``, and per route
in ``group_launches`` and ``slot_launches``.

Both kernels run on the group route: the candidate slots are put in group
order first (:func:`slot_order`), and a block stages each group of its
``qb`` ordered slots once and scores it for every slot that picked it, on
the tensor cores (:func:`grouped_plan`). The kernel they replaced, a block per (``qb``
queries, candidate slot) that reads a group once for every query that
picked it, stays as the ``slot`` route, which only ``chip_smoke.py`` takes,
through :data:`ROUTE`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _SMEM_BYTES, GROUP, _candidate_rows, _check_cand, _on_cuda, _stream, _vec, group_order,
    group_order_ref, num_groups)

#: (query, group) pairs per kernel block, the TPU grid step's QB
#: (gather_kernel_sweep.py:55-57): ordered slots on the group route, queries
#: of one candidate slot on the slot route
QBS = (8, 16, 32)
#: the kernels' routes: "group", the slots in group order, each group staged
#: once a block (every caller), and "slot", the kernel it replaced
#: (``chip_smoke.py``'s comparison only)
ROUTES = ("group", "slot")
#: the route the wrappers launch on CUDA tensors; ``chip_smoke.py`` alone
#: sets it to "slot", for the length of a comparison
ROUTE = "group"
#: the group route's ring by ``qb``: stages of 128 rows x 128 bf16 columns
#: (32 KB). A block of 8 slots holds two or three runs at bench.py's point,
#: so one stage lets four blocks share an SM (as many as their registers
#: allow), whose copies overlap one another's set-up; larger blocks hold
#: more runs, and a second stage keeps the next one's copy in flight
#: (chip_smoke.py phase 7 times both routes at every qb; PERF.md rows 14-16)
GROUPED_STAGES = {8: 1, 16: 2, 32: 2}
_STAGE_BYTES = GROUP * 128 * 2
_ALIGN = 1024  # the 128-byte swizzle's alignment of the ring
_PAD_BYTES = 16  # appended to each staged query row (SMEM_PAD_BYTES, csrc/mma.cuh)
#: rows past this cannot be addressed by the tensor map's 32-bit coordinates
_TMA_MAX_ROWS = 2 ** 31 - 1 - GROUP
#: bytes of shared memory :func:`slot_order`'s one block may give its bins
#: and its order (4 bytes each; an H100 block's 227 KB, less 1 KB): bench.py's
#: point fits up to Q = 4096 at t = 12
ORDER_SMEM_BYTES = 232_448 - 1024


class GroupedPlan(NamedTuple):
    """The group route's launch: ``blocks`` of ``qb`` ordered slots each,
    ``stages`` ring stages, ``smem`` bytes of dynamic shared memory, and
    whether the Tensor Memory Accelerator stages the store's rows (``tma``;
    else the block's threads copy them)."""

    blocks: int
    stages: int
    smem: int
    tma: bool


def grouped_plan(nq: int, t: int, d: int, qb: int, tma: bool) -> GroupedPlan:
    """The group route's launch for Q = ``nq``, t candidate slots a query,
    rows of ``d``: a block per ``qb`` ordered slots, ceil(Q t / qb) blocks
    (known without reading the order); ``GROUPED_STAGES[qb]`` ring stages;
    shared memory for the ring and ``qb`` bf16 query rows of d rounded up to 16, each padded
    (``grouped_smem`` in ``csrc/rescore_variants.cu``: the same sum)."""
    dp = -(-d // 16) * 16
    stages = GROUPED_STAGES[qb]
    smem = _ALIGN + stages * _STAGE_BYTES + qb * (dp * 2 + _PAD_BYTES)
    return GroupedPlan(-(-nq * t // qb), stages, smem, tma)


def _tma_rows(x: torch.Tensor) -> bool:
    """Store rows the Tensor Memory Accelerator can tile: 16-byte multiples
    at a 16-byte aligned base, and few enough for its coordinates."""
    return x.shape[1] % 8 == 0 and x.data_ptr() % 16 == 0 and x.shape[0] <= _TMA_MAX_ROWS


def slot_order(cand: torch.Tensor, ngroups: int) -> torch.Tensor:
    """The flat (Q, t) candidate slots grouped by group id, groups ascending
    (ids below 0 first, ids of ``ngroups`` or more last), int32: the group
    route's order. On the card a one-block counting sort whose bins and
    order stay in shared memory (``rescore_order_kernel``), where they fit
    in ``ORDER_SMEM_BYTES``; beyond,
    :func:`~image_search_engine_tpu_torch.ops.topk.group_order`, whose bins
    live in device memory. Either orders a group's slots in any way; on the
    CPU the plain version, a stable argsort. Counts its own kernel's
    launches in ``slot_order.launches``."""
    _check_cand(cand, cand.shape[0])
    if not _on_cuda(cand):
        return slot_order_ref(cand, ngroups)
    smem = (ngroups + 2 + cand.numel()) * 4
    if smem > ORDER_SMEM_BYTES:
        return group_order(cand, ngroups).order
    order = torch.empty(cand.numel(), dtype=torch.int32, device=cand.device)
    if cand.numel() == 0:
        return order
    with torch.cuda.device(cand.device):
        err = _kernels.library().ise_rescore_order(cand.data_ptr(), order.data_ptr(),
                                                   cand.numel(), ngroups, smem, _stream(cand))
    _kernels.check(err, "slot_order")
    slot_order.launches += 1
    return order


slot_order.launches = 0


def slot_order_ref(cand: torch.Tensor, ngroups: int) -> torch.Tensor:
    """Plain version of :func:`slot_order`: ``group_order_ref``'s order."""
    return group_order_ref(cand, ngroups).order


def _route() -> str:
    if ROUTE not in ROUTES:
        raise ValueError(f"ROUTE={ROUTE!r} not in {ROUTES}")
    return ROUTE


def _check(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, qb: int) -> None:
    if q.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"want a bf16 query and store, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    for name, t in (("q", q), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_cand(cand, q.shape[0])
    ng = num_groups(x.shape[0])
    if not 0 < cand.shape[1] <= ng:
        raise ValueError(f"t={cand.shape[1]} outside (0, ngroups={ng}]")
    if qb not in QBS:
        raise ValueError(f"qb={qb} not in {QBS}")


def _launch(fn, q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, qb: int) -> torch.Tensor:
    nq, d = q.shape
    t = cand.shape[1]
    if qb * d * 4 > _SMEM_BYTES:
        raise ValueError(f"{qb} query rows of d={d} exceed the kernel's shared-memory tile")
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0:
        return out
    route = _route()
    n = x.shape[0]
    with torch.cuda.device(x.device):
        lib = _kernels.library()
        if route == "group":
            p = grouped_plan(nq, t, d, qb, _tma_rows(x))
            order = slot_order(cand, num_groups(n))
            err = getattr(lib, f"ise_{fn.__name__}_grouped")(
                q.data_ptr(), x.data_ptr(), cand.data_ptr(), order.data_ptr(), out.data_ptr(),
                nq, n, d, t, qb, p.stages, p.smem, int(p.tma), _stream(x))
        else:
            err = getattr(lib, f"ise_{fn.__name__}")(
                q.data_ptr(), x.data_ptr(), cand.data_ptr(), out.data_ptr(), nq, n, d, t, qb,
                _vec(x), _stream(x))
    _kernels.check(err, fn.__name__)
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)
    return out


def rescore_gather(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor,
                   qb: int = 8) -> torch.Tensor:
    """Scores x.x - 2 q.x for every row of each query's candidate groups,
    the squared norm taken from the bf16 row itself: cand (Q, t) int32
    group ids -> (Q, t*128) f32. Rows past N score +inf.

    Replaces ``rescore_kernel`` (benchmarks/gather_kernel_proto.py:49,
    launched :119; the same body at benchmarks/gather_kernel_sweep2.py:40,
    launched :112). What bounds it on the card: the gathered bytes, the
    distinct candidate groups' rows read from scattered 128-row blocks. The
    design reads each picked group about once per batch: the slots in group
    order (:func:`slot_order`), a block per ``qb`` of them
    (:func:`grouped_plan`), which stages each of its groups once by the
    Tensor Memory Accelerator (a ring of ``GROUPED_STAGES[qb]`` stages) and
    scores it against all of the queries that picked it with bf16
    ``mma.sync`` (f32 sums), squaring the staged rows' fragments for x.x
    once per row. On the ``slot`` route (:data:`ROUTE`), the kernel it
    replaced: a block per ``qb`` queries of one candidate slot, a half-warp
    per row in f32 FMAs.
    """
    _check(q, x, cand, qb)
    if not _on_cuda(q, x, cand):
        return rescore_gather_ref(q, x, cand)
    return _launch(rescore_gather, q, x, cand, qb)


rescore_gather.launches = 0
rescore_gather.group_launches = 0  # of those, the group route's
rescore_gather.slot_launches = 0  # and the slot route's (chip_smoke.py's comparison)


def rescore_cross(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor,
                  qb: int = 8) -> torch.Tensor:
    """The raw cross products q.x for every row of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32. Rows past N give
    0, as the TPU script's zero-padded store does; its caller adds the
    gathered norms (PAD_NORM past N).

    Replaces ``_cross_only_kernel`` (benchmarks/rescore_dma_variants.py:33,
    launched :109). What bounds it on the card: the gathered bytes, as
    :func:`rescore_gather`, whose design and routes it shares without the
    x.x sums.
    """
    _check(q, x, cand, qb)
    if not _on_cuda(q, x, cand):
        return rescore_cross_ref(q, x, cand)
    return _launch(rescore_cross, q, x, cand, qb)


rescore_cross.launches = 0
rescore_cross.group_launches = 0
rescore_cross.slot_launches = 0


def _gathered(q: torch.Tensor, x: torch.Tensor,
              cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(valid (Q, t*128), the candidate rows widened to f32 (Q, t*128, d),
    their f32 cross products with the query (Q, t*128))."""
    nq, t = cand.shape
    valid, safe = _candidate_rows(cand, x.shape[0])
    xs = x[safe.reshape(-1)].float().view(nq, t * GROUP, x.shape[1])
    return valid, xs, torch.bmm(xs, q.float()[:, :, None])[:, :, 0]


def rescore_gather_ref(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_gather`: gather, batched f32 product,
    norms of the gathered rows."""
    valid, xs, cross = _gathered(q, x, cand)
    scores = (xs ** 2).sum(-1) - 2.0 * cross
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


def rescore_cross_ref(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_cross`: gather, batched f32 product."""
    valid, _, cross = _gathered(q, x, cand)
    return torch.where(valid, cross, torch.zeros_like(cross))


KERNELS = (rescore_gather, rescore_cross)


def reset_launch_counts() -> None:
    slot_order.launches = 0
    for fn in KERNELS:
        fn.launches = 0
        for route in ROUTES:
            setattr(fn, f"{route}_launches", 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
