"""The phase-1 group-min sweep's prototype variants (``csrc/groupmin_width_mma.cu``,
``csrc/groupmin_two_level_mma.cu``, ``csrc/groupmin_variants.cu``).

Ports of the TPU prototypes under the JAX repo's ``benchmarks/``, each the
production sweep (:func:`~image_search_engine_tpu_torch.ops.topk.groupmin`:
the min of norms - 2 q.x over groups of store rows) with one thing changed:

  * :func:`groupmin_width`: the group width G in {128, 64, 32}
    (``rescore_variants2.py``);
  * :func:`groupmin_two_level`: the 128-row group mins and, from the same
    sweep, the 32-row subgroup mins rounded to bf16, in three output layouts
    (``subgroup_proto.py``, ``subgroup_variants.py``);
  * :func:`groupmin_chunked`: each 4096-row tile's product done 512 or 1024
    rows at a time, each chunk's mins before the next (``sweep_chunked.py``).

The width and two-level kernels are production's bf16 tensor-core sweep
(``csrc/groupmin_mma.cuh``, on :func:`~image_search_engine_tpu_torch.ops.
topk.mma_plan`'s tiles) with another output policy in its epilogue, so
what each changes is all that separates its time from ``groupmin``'s, and
their 128-row mins are ``groupmin``'s bit for bit. The CUDA-core kernels
they replaced (a warp per row scored by ``row_dot``, the design production
``groupmin`` ran for bf16 before its tensor cores) stay as the ``cuda_core``
route, which only ``chip_smoke.py`` takes, through :data:`ROUTE`.

As in the prototypes, the query and the store are bf16 (f32 sums) and the
mins are group-major, (groups, Q). Rows of a ragged last group past N count
as +inf; nothing is padded. Each wrapper launches its CUDA kernel for CUDA
tensors (or raises) and runs its plain PyTorch version (``*_ref``: one f32
product, then mins over slices) for CPU tensors, and counts its launches in
``<wrapper>.launches`` (the width and two-level ones also per route, in
``mma_launches`` and ``cuda_core_launches``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (GROUP, MmaPlan, _on_cuda, _query_tile,
                                                    _stream, _vec_mma, mma_plan)

SUB = 32  # subgroup width of the two-level sweep
WIDTHS = (128, 64, 32)
LAYOUTS = ("v1", "v2", "v3")
CHUNKS = (512, 1024)
#: the width and two-level kernels' routes: "mma", the tensor-core sweep
#: (every caller), and "cuda_core", the row_dot kernels it replaced
#: (``chip_smoke.py``'s comparison only)
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


def groupmin_chunked(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """The 128-row group mins, (ngroups, Q) f32 group-major, with each
    4096-row tile scored ``chunk`` rows (512 or 1024) at a time: the same
    function as ``groupmin(...).T``, its sums in another order.

    Replaces ``chunked_kernel`` (benchmarks/sweep_chunked.py:53, launched
    :74). What bounds it on the card: the 2*Q*N*d products. The design is
    the CUDA form of "a chunk's product, then its mins": a block stages a
    tile of 32768 / ``chunk`` queries (64 or 32) and the chunk's rows in shared memory
    a slice of 8 columns at a time, each thread accumulates an 8-query x
    16-row register tile with f32 FMAs, the (queries x chunk) scores go to
    shared memory, and each warp takes the min of 128-row groups of them,
    then the next chunk. Rows must be 16-byte multiples (d % 8 == 0).
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
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_groupmin_chunked(
            q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, chunk,
            _stream(x))
    _kernels.check(err, "groupmin_chunked")
    groupmin_chunked.launches += 1
    return out


groupmin_chunked.launches = 0


def groupmin_chunked_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin_chunked` (every chunk gives the same
    function): an f32 product, then 128-row mins."""
    return groupmin_width_ref(q, x, norms, GROUP)


KERNELS = (groupmin_width, groupmin_two_level, groupmin_chunked)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in (groupmin_width, groupmin_two_level):
        for route in ROUTES:
            setattr(fn, f"{route}_launches", 0)
