"""Pairwise distances and exact top-k by full scan — the plain reference.

Port of ``image_search_engine_tpu/ops/distances.py``. ``topk_flat`` is the
oracle the two-phase search is tested against. Same conventions: l2 and
chi2 return distances ascending; ip/cosine return inner products
descending (Faiss ``IndexFlatL2`` / ``IndexFlatIP`` semantics).
"""

from __future__ import annotations

from typing import Tuple

import torch

_DESCENDING = frozenset({"ip", "cosine"})


def stable_smallest(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row in (value, position) order: ties to the
    lowest position, as ``lax.top_k`` of the negated values."""
    v, pos = torch.sort(vals, dim=1, stable=True)
    return v[:, :k], pos[:, :k]


def stable_largest(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, ties to the lowest position,
    as ``lax.top_k``. The values are gathered, not negated back, so a zero
    keeps its sign."""
    _, pos = stable_smallest(-vals, k)
    return torch.gather(vals, 1, pos), pos


def stable_topk(vals: torch.Tensor, k: int, largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return stable_largest(vals, k) if largest else stable_smallest(vals, k)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared L2 distances via ||q||^2 - 2 q.x + ||x||^2, clamped at 0."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(x * x, dim=-1)
    return torch.clamp(qn - 2.0 * (q @ x.T) + xn[None, :], min=0.0)


def pairwise_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, N) inner products."""
    return q @ x.T


def pairwise_cosine(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity: IP over L2-normalized rows."""
    return pairwise_ip(l2_normalize(q), l2_normalize(x))


def pairwise_chi2(q: torch.Tensor, x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(Q, N) chi-square distances between histogram rows,
    0.5 * sum_i (a_i - b_i)^2 / (a_i + b_i + eps). Elementwise, O(Q*N*d)
    memory: no matmul form."""
    diff = q[:, None, :] - x[None, :, :]
    denom = q[:, None, :] + x[None, :, :] + eps
    return 0.5 * torch.sum(diff * diff / denom, dim=-1)


_METRIC_FNS = {"l2": pairwise_sq_l2, "ip": pairwise_ip, "cosine": pairwise_cosine,
               "chi2": pairwise_chi2}


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    try:
        return _METRIC_FNS[metric](q, x)
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; want one of {sorted(_METRIC_FNS)}")


def topk_flat(q: torch.Tensor, x: torch.Tensor, k: int,
              metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a flat store by full scan: (distances (Q, k),
    indices (Q, k)), ascending for l2/chi2, descending for ip/cosine; ties
    go to the lowest row id, as ``lax.top_k``."""
    return stable_topk(pairwise(q, x, metric), k, metric in _DESCENDING)


def topk_flat_chunked(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2",
                      chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_flat` with the store streamed in row chunks: each
    chunk's top-k, then one merge, so the distance matrix is at most (Q,
    chunk). Same results as :func:`topk_flat`."""
    n = x.shape[0]
    if n <= chunk:
        return topk_flat(q, x, k, metric)
    vals, idx = [], []
    for s in range(0, n, chunk):
        v, i = topk_flat(q, x[s:s + chunk], min(k, x[s:s + chunk].shape[0]), metric)
        vals.append(v)
        idx.append(i + s)
    # chunks in row order, each sorted with ties to its lowest row: the
    # stable merge keeps ties to the lowest row id
    mvals, mpos = stable_topk(torch.cat(vals, 1), k, metric in _DESCENDING)
    return mvals, torch.gather(torch.cat(idx, 1), 1, mpos)
