"""Exact squared-l2 k-NN in float64, blocked over the store's rows: the
benchmark's reference search.

``rank`` are the queries as the search ranks with them (the bf16 store's
queries cast to bf16, as the configuration states), ``qnorm`` the squared
norm the reported distance adds (of the uncast query). A distance is
``qnorm + |x|^2 - 2 rank . x`` over the store's values (the bf16-rounded
rows for a bf16 store), every term in float64. ``blocks`` yields (first
row id, rows) so that the rows can be made block by block and never held
whole. Beside the best k it scores the rows named in ``probe`` (the ids
that a search under test returned), so that its answers can be judged
against the best. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def exact_knn(rank: torch.Tensor, qnorm: torch.Tensor, blocks: Iterable[Tuple[int, torch.Tensor]],
              k: int, probe: torch.Tensor | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(best distances (Q, k) ascending, their ids (Q, k), the distances
    of ``probe``'s ids (Q, m), +inf where an id is outside the rows), all
    float64 / int64 on ``rank``'s device."""
    dev = rank.device
    q = rank.to(torch.float64)
    qn = qnorm.to(device=dev, dtype=torch.float64)[:, None]
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=dev)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.long, device=dev)
    probe_d = None
    if probe is not None:
        probe = probe.to(device=dev, dtype=torch.long)
        probe_d = torch.full(probe.shape, float("inf"), dtype=torch.float64, device=dev)
    for start, rows in blocks:
        x = rows.to(device=dev, dtype=torch.float64)
        dist = qn - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
        if probe is not None:
            local = probe - start
            inside = (local >= 0) & (local < x.shape[0])
            got = torch.gather(dist, 1, local.clamp(0, x.shape[0] - 1))
            probe_d = torch.where(inside, got, probe_d)
        ids = torch.arange(start, start + x.shape[0], device=dev).expand(q.shape[0], -1)
        cat_d = torch.cat([best_d, dist], 1)
        cat_i = torch.cat([best_i, ids], 1)
        best_d, pos = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d, best_i, probe_d


def judge(got_d: torch.Tensor, got_i: torch.Tensor, best_d: torch.Tensor,
          probe_d: torch.Tensor, n_rows: int) -> dict:
    """The numbers that judge a search's answers (distances ``got_d`` and
    ids ``got_i``, (Q, k)) against the exact ones, each as a share of the
    query's k-th best distance:

    - ``rank_gap``: the widest gap between the exact distance of the row
      returned at rank j and the best distance at rank j;
    - ``dist_err``: the widest gap between a returned distance and the
      exact distance of the row it names;
    - ``bad_ids``: answers naming no row, or a row twice for one query.
    """
    got_i = got_i.to(torch.long)
    kth = best_d[:, -1:].clamp_min(torch.finfo(torch.float64).tiny)
    bad = (got_i < 0) | (got_i >= n_rows)
    srt = got_i.sort(1).values
    dup = torch.zeros_like(bad)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    n_bad = int(bad.sum()) + int(dup.sum())
    rank_gap = ((probe_d - best_d).abs() / kth).max()
    dist_err = ((got_d.to(torch.float64).to(best_d.device) - probe_d).abs() / kth).max()
    inf = float("inf")
    return {"rank_gap": inf if n_bad else float(rank_gap),
            "dist_err": inf if n_bad else float(dist_err),
            "bad_ids": float(n_bad)}
