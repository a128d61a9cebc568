"""Batched IVF probed scan: rank buckets, score the probed buckets in
place, select the top k.

Port of ``image_search_engine_tpu/ops/ivf_pallas.py``. The packed table is
list-contiguous (nbuckets, cap, d) (index/ivf.py ``_pack``), so a probed
bucket is one contiguous (cap, d) block and no (Q, nprobe*cap, d) gather
buffer is built. Pad slots inside a bucket carry +inf norms and finite
rows, so they score +inf and never win: validity rides in data, as the
flat store's pad poisoning.

``probed_scan`` is a hand-written CUDA kernel (``csrc/ivf_probed_scan.cu``)
on two routes, chosen by the pure :func:`probed_scan_plan` (slot by slot,
or bucket by bucket for batches whose slots share buckets), with its plain
PyTorch version ``probed_scan_ref`` beside it; the wrapper runs the plain
version only for CPU tensors and launches the kernel or raises for CUDA
tensors, counting launches in ``probed_scan.launches`` and per route in
``probed_scan.slot_launches`` and ``probed_scan.bucket_launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _DTYPE_CODES, _SMEM_BYTES, _on_cuda, _stream, _vec, group_order, select_topt)

#: rows of at most this many bytes: the slot route reads them with the tile
#: kernel (a block's slice of rows staged in shared memory) beyond one query,
#: wider rows and a single query's with the row kernel (one warp a row, its
#: loads in registers). probed_scan_sweep.py on an H100 80GB HBM3 at 700 W:
#: over rows of 256 and 512 bytes the tile kernel was faster from Q = 2 (by
#: 6-7% there, by 43-64% at Q = 64) and 2-7% slower at Q = 1; over rows of
#: 1024 bytes slower up to Q = 8, of 2048 and 4096 bytes at every Q
_SLOT_TILE_ROW_BYTES = 512
#: rows of at most this many bytes are narrow: a warp of the tile kernel
#: scores _TILE_R of them at once (against 2 slots, TILE_Q), a wider row
#: alone
_NARROW_ROW_BYTES = 1024
#: (slots, share of the buckets): probed_scan runs a batch of more than one
#: query bucket by bucket when its Q * nprobe slots number at least
#: max(slots, share * nbuckets), by the slot route's kernel for the row width
#: ("tile", "row": _SLOT_TILE_ROW_BYTES). The bucket route pays once enough
#: slots share a bucket: in probed_scan_sweep.py (H100 80GB HBM3, 700 W) it
#: lost at 1.2 slots a distinct bucket and won from 1.5 at every row width,
#: whose slot count depends on how the queries cluster. These rules put the
#: crossing between the measured batches of chip_smoke.py phase 3's tables:
#: the batched-IVF point's rows of 256 and 512 bytes (the slot route at Q =
#: 32, 192 slots over 1407 buckets; the bucket route at Q = 64, 384 slots)
#: and IVF-PQ's rows of 4096 bytes (the slot route at Q = 64, 384 slots over
#: 1381 buckets; the bucket route at Q = 128), where the row kernel is the
#: faster slot route and a tile of wide rows costs more
PROBED_SCAN_BUCKET_MIN = {"tile": (256, 0.2), "row": (512, 0.5)}
#: the tile kernel's rows a block: as many as fill this much shared memory
#: (several blocks an SM, to hide the latency of their short dot products),
#: at least one a warp, a multiple of the rows a warp scores at once, at
#: most _TILE_MAX_ROWS
_TILE_SMEM_TARGET = 24 * 1024
_TILE_MIN_ROWS = 8
_TILE_MAX_ROWS = 256
_TILE_R = 8


@dataclass(frozen=True)
class ProbedScanPlan:
    """How :func:`probed_scan` runs: ``route`` "slot" (a block per (slot,
    row slice)) or "bucket" (the slots grouped by bucket, a block per
    (bucket, row slice)); ``rows`` 0, the row kernel (one warp a row), else
    the tile kernel staging ``rows`` table rows a block in ``smem`` bytes of
    shared memory, a warp scoring ``r`` of them at once."""

    route: str
    rows: int
    r: int
    smem: int


def probed_scan_plan(nq: int, nprobe: int, nbuckets: int, cap: int, d: int, itemsize: int,
                     route: str | None = None) -> ProbedScanPlan:
    """:func:`probed_scan`'s plan for Q = nq queries of nprobe probes over a
    (nbuckets, cap, d) table of ``itemsize``-byte elements: bucket by bucket
    for a batch whose slots reach ``PROBED_SCAN_BUCKET_MIN`` for the row
    width, else slot by slot (or the ``route`` asked for); the kernel and its
    tile by the route, the row width and, on the slot route, Q."""
    if nq < 1 or nprobe < 1 or nbuckets < 1 or cap < 1 or d < 1:
        raise ValueError(f"no probed-scan plan for Q={nq}, nprobe={nprobe}, "
                         f"table ({nbuckets}, {cap}, {d})")
    row = d * itemsize
    slots, share = PROBED_SCAN_BUCKET_MIN["tile" if row <= _SLOT_TILE_ROW_BYTES else "row"]
    if route is None:
        route = ("bucket" if nq > 1 and nq * nprobe >= max(slots, share * nbuckets)
                 else "slot")
    elif route not in ("slot", "bucket"):
        raise ValueError(f"no probed-scan route {route!r}")
    if route == "slot" and (row > _SLOT_TILE_ROW_BYTES or nq == 1):
        return ProbedScanPlan(route, 0, 1, 0)
    r = _TILE_R if row <= _NARROW_ROW_BYTES else 1
    rows = min(max(_TILE_SMEM_TARGET // row, _TILE_MIN_ROWS), _TILE_MAX_ROWS)
    rows = max(1, min(rows - rows % r, cap, (_SMEM_BYTES - 16) // (row + 4)))
    return ProbedScanPlan(route, rows, r, -(-rows * row // 16) * 16 + 4 * rows)


def probed_scan(q: torch.Tensor, packed: torch.Tensor, packed_norms: torch.Tensor,
                probe: torch.Tensor) -> torch.Tensor:
    """Scores ``packed_norms[b, r] - 2 q.packed[b, r]`` for every row r of
    each query's probed buckets: q (Q, d) in the table dtype, packed
    (nbuckets, cap, d) f32 or bf16, packed_norms (nbuckets, cap) f32 (+inf
    at pad slots), probe (Q, P) int32 bucket ids -> (Q, P*cap) f32; column
    p*cap + r is row r of bucket probe[:, p]. A probe id outside [0,
    nbuckets) scores +inf.

    Replaces ``_probed_scan_kernel`` (image_search_engine_tpu/ops/
    ivf_pallas.py:36, launched :153). What bounds it on the card: the bytes
    of the distinct probed buckets, cap*d*itemsize each, read from scattered
    contiguous blocks; the 2*cap*d flops per slot are far below the f32
    rate, so it is a memory-bandwidth kernel. No padding or copy (the TPU
    wrapper padded cap and d to 128; here the kernels mask the ragged edge).
    Two routes (:func:`probed_scan_plan`): "slot", a block per (slot, row
    slice); "bucket", for batches whose slots share buckets (at Q = 1024 a
    bucket would otherwise be read ~6 times), the slots grouped by bucket
    with ``ops/topk.group_order`` (the int8 rescore's counting sort), then a
    block per (bucket, row slice) serving every slot that probes the
    bucket. Two kernels: the slot route over rows wider than 512 bytes (d =
    2048) or for a single query one warp a row, each lane issuing all its
    16-byte loads of the row before the block stages the query, so that a
    single query's handful of probes keeps its rows in flight; otherwise a
    slice of rows copied into shared memory (a bulk copy of the Tensor
    Memory Accelerator), a warp scoring 8 narrow rows (or 1 wide one)
    against 2 slots' queries (read from L2) at a time. Each (row, query) pair is scored by the flat search's per-row
    arithmetic (csrc/scoring.cuh ``row_dot``: the same lane partition, f32
    fmaf order and butterfly tree; a narrow tile's 16 butterflies are
    folded into one transposed reduction), so both kernels and routes give
    the same bits.
    """
    if packed.dtype not in _DTYPE_CODES:
        raise ValueError(f"table dtype must be float32 or bfloat16, got {packed.dtype}")
    if q.dim() != 2 or packed.dim() != 3 or q.shape[1] != packed.shape[2]:
        raise ValueError(f"want q (Q, d) and packed (nbuckets, cap, d), got "
                         f"{tuple(q.shape)} and {tuple(packed.shape)}")
    if q.dtype != packed.dtype:
        raise ValueError(f"query dtype {q.dtype} must equal the table dtype {packed.dtype}")
    if packed_norms.dtype != torch.float32 or packed_norms.shape != packed.shape[:2]:
        raise ValueError("packed_norms must be float32 of shape (nbuckets, cap)")
    if probe.dtype != torch.int32 or probe.dim() != 2 or probe.shape[0] != q.shape[0]:
        raise ValueError("probe must be int32 of shape (Q, nprobe)")
    for name, t in (("q", q), ("packed", packed), ("packed_norms", packed_norms),
                    ("probe", probe)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not _on_cuda(q, packed, packed_norms, probe):
        return probed_scan_ref(q, packed, packed_norms, probe)
    nq, d = q.shape
    nb, cap, _ = packed.shape
    nprobe = probe.shape[1]
    if d * 4 > _SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory query row")
    out = torch.empty((nq, nprobe * cap), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    plan = probed_scan_plan(nq, nprobe, nb, cap, d, packed.element_size())
    vec = _vec(packed.view(nb * cap, d))
    if vec > 1 and q.data_ptr() % 16:  # the kernels read the query 16 bytes at a time
        q = q.clone()
    with torch.cuda.device(q.device):
        if plan.route == "bucket":
            grouped = group_order(probe, nb)
            err = _kernels.library().ise_probed_scan_bucket(
                _DTYPE_CODES[packed.dtype], q.data_ptr(), packed.data_ptr(),
                packed_norms.data_ptr(), probe.data_ptr(), grouped.order.data_ptr(),
                grouped.ends.data_ptr(), grouped.live.data_ptr(), out.data_ptr(), nq, nprobe, nb,
                cap, d, vec, plan.rows, plan.r, plan.smem, _stream(q))
        else:
            err = _kernels.library().ise_probed_scan(
                _DTYPE_CODES[packed.dtype], q.data_ptr(), packed.data_ptr(),
                packed_norms.data_ptr(), probe.data_ptr(), out.data_ptr(), nq, nprobe, nb, cap,
                d, vec, plan.rows, plan.r, plan.smem, _stream(q))
    _kernels.check(err, "probed_scan")
    probed_scan.launches += 1
    if plan.route == "bucket":
        probed_scan.bucket_launches += 1
    else:
        probed_scan.slot_launches += 1
    return out


probed_scan.launches = 0
probed_scan.slot_launches = 0  # of those, the slot route's
probed_scan.bucket_launches = 0  # and the bucket route's


def probed_scan_ref(q: torch.Tensor, packed: torch.Tensor, packed_norms: torch.Tensor,
                    probe: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`probed_scan`: gather the probed buckets,
    batched f32 matmul."""
    nq, nprobe = probe.shape
    nb, cap = packed.shape[:2]
    valid = (probe >= 0) & (probe < nb)
    safe = torch.where(valid, probe, 0).long()
    rows = packed[safe].float().view(nq, nprobe * cap, -1)
    cross = torch.bmm(rows, q.float()[:, :, None])[:, :, 0]
    scores = packed_norms[safe].view(nq, nprobe * cap) - 2.0 * cross
    mask = valid.repeat_interleave(cap, dim=1)
    return torch.where(mask, scores, torch.full_like(scores, float("inf")))


def rank_buckets(q: torch.Tensor, bucket_centroids: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest bucket centroids per query, (Q, nprobe) int64,
    nearest first; equal distances go to the lowest bucket id (as
    ``lax.top_k``), so a split cell's buckets, whose centroids are exact
    duplicates, are probed in id order. A plain f32 matmul and a stable
    sort: the product is computed outside the kernel in the JAX package too.
    """
    c = bucket_centroids.float()
    cd = (c * c).sum(1)[None, :] - 2.0 * (q.float() @ c.T)
    return torch.sort(cd, dim=1, stable=True)[1][:, :nprobe]


def ivf_probed_topk(q: torch.Tensor, bucket_centroids: torch.Tensor, packed: torch.Tensor,
                    packed_norms: torch.Tensor, lists: torch.Tensor, k: int,
                    nprobe: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched IVF search through the probed scan.

    q (Q, d) f32; bucket_centroids (nbuckets, d) f32; packed (nbuckets,
    cap, d) f32 or bf16; packed_norms (nbuckets, cap) f32, +inf at pad
    slots; lists (nbuckets, cap) int32 global row ids, -1 at pad slots.
    Returns (dist (Q, k') ascending squared L2, ids (Q, k') int32, ok (Q, k')
    bool) with k' = min(k, nprobe*cap).

    The final select is the flat search's ``select_topt`` (the CUDA select
    kernel on the card): ascending (score, position) order, ties to the
    lowest position, as the JAX package's ``_select_topt``. It takes the
    query-major (Q, W) scores as they are, so the TPU path's (W, Q)
    relayout and its VMEM and ``w % 8`` guards have no counterpart.
    """
    nq = q.shape[0]
    cap = packed.shape[1]
    probe = rank_buckets(q, bucket_centroids, nprobe)
    scores = probed_scan(q.to(packed.dtype).contiguous(), packed, packed_norms,
                         probe.to(torch.int32).contiguous())
    cand = lists[probe].reshape(nq, nprobe * cap)
    w = nprobe * cap
    kk = min(k, w)
    if kk < w:
        vals, pos = select_topt(scores, kk)
    else:  # every slot is a result: a stable sort is the select's order
        vals, pos = torch.sort(scores, dim=1, stable=True)
    ids = torch.gather(cand, 1, pos.long())
    ok = torch.isfinite(vals) & (ids >= 0)
    qnorm = (q.float() * q.float()).sum(1, keepdim=True)
    return torch.clamp(vals + qnorm, min=0.0), ids, ok
