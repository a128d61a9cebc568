"""Merged single-launch two-phase exact top-k.

Port of ``image_search_engine_tpu/ops/topk_merged.py``: the group-min
sweep, the candidate select and the candidate rescore of
:func:`~image_search_engine_tpu_torch.ops.topk.topk_twophase` in one
program (``csrc/topk_merged.cu``, one cooperative launch), then the same
stable candidate sort, id rebuild and certificate as the two-phase search.
f32 and bf16 stores, l2, ip and cosine, k <= 128, no escalation: with
``with_certificate`` the caller sees which queries are proved exact.

On the card it equals ``topk_twophase(..., t_margin=t_margin)`` bit for bit
(the same row routine, the same work items, the same select order); on the
CPU both run the same plain versions. The JAX package counts t = min(k +
t_margin, ngroups) over a store padded to its tile, so the two packages
agree whenever k + t_margin <= ceil(N / 128), the real group count the port
uses; below that the port rescores every real group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _DTYPE_CODES,
    _check_scoring_args,
    _cosine_as_ip,
    _on_cuda,
    _query_tile,
    _search_norms,
    _stream,
    _vec,
    GROUP,
    KERNEL_MAX_K,
    finish_candidates,
    groupmin_ref,
    num_groups,
    rescore_ref,
    select_topt_ref,
)


def merged_candidates(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                      t: int) -> Tuple[torch.Tensor, ...]:
    """The two-phase search's three steps in one launch: (scores (Q, t*128)
    f32, cand (Q, t) int32, threshold (Q,) f32, mins (Q, ngroups) f32).
    ``mins`` are the per-128-row group mins of norms - 2 q.x; ``cand`` the t
    groups with the smallest mins in ascending (value, group id) order, or
    every group in order when t = ngroups; ``threshold`` the t-th selected
    min (+inf when t = ngroups); ``scores`` every row of the candidate
    groups, column j*128 + i for row cand[:, j]*128 + i, +inf past N. ``q``
    is already in the store dtype (and halved for ip).

    Replaces ``_merged_kernel`` (image_search_engine_tpu/ops/topk_merged.py:
    66, launched :337). What bounds it on the card: what bounds the
    two-phase search, one read of the store per query tile (bytes at
    serving batch sizes, the 2*Q*N*d operations at large Q) and then the
    candidate rows. The design is one cooperative launch sized to the card
    (every block resident), three grid-stride stages over the three
    kernels' work items, separated by grid-wide barriers; the stages call
    the group-min, select and rescore kernels' own routines, so the result
    is theirs bit for bit. It raises, and never falls back to three
    launches, if the card refuses the launch.
    """
    _check_scoring_args(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    ng = num_groups(n)
    if not 0 < t <= ng:
        raise ValueError(f"t={t} outside (0, ngroups={ng}]")
    if not _on_cuda(q, x, norms):
        return merged_candidates_ref(q, x, norms, t)
    qt = _query_tile(nq, d * 4)
    dev = x.device
    scores = torch.empty((nq, t * GROUP), dtype=torch.float32, device=dev)
    cand = torch.empty((nq, t), dtype=torch.int32, device=dev)
    threshold = torch.empty((nq,), dtype=torch.float32, device=dev)
    mins = torch.empty((nq, ng), dtype=torch.float32, device=dev)
    if nq == 0:
        return scores, cand, threshold, mins
    with torch.cuda.device(dev):
        err = _kernels.library().ise_topk_merged(
            _DTYPE_CODES[x.dtype], q.data_ptr(), norms.data_ptr(), x.data_ptr(),
            mins.data_ptr(), cand.data_ptr(), threshold.data_ptr(), scores.data_ptr(),
            nq, n, d, qt, t, _vec(x), _stream(x))
    _kernels.check(err, "topk_merged")
    merged_candidates.launches += 1
    return scores, cand, threshold, mins


merged_candidates.launches = 0


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
