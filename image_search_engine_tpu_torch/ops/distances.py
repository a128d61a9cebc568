"""Pairwise distances and exact top-k by full scan — the plain reference.

Port of ``image_search_engine_tpu/ops/distances.py``. ``topk_flat`` is the
oracle the two-phase search is tested against. Same conventions: l2
returns squared distances ascending; ip/cosine return inner products
descending (Faiss ``IndexFlatL2`` / ``IndexFlatIP`` semantics).
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.utils.unported import not_ported

_DESCENDING = frozenset({"ip", "cosine"})


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


_METRIC_FNS = {"l2": pairwise_sq_l2, "ip": pairwise_ip, "cosine": pairwise_cosine}


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "chi2":
        raise not_ported("the chi2 metric", "chi2")
    try:
        return _METRIC_FNS[metric](q, x)
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; want one of {sorted(_METRIC_FNS)}")


def topk_flat(q: torch.Tensor, x: torch.Tensor, k: int,
              metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a flat store by full scan: (distances (Q, k),
    indices (Q, k)), ascending for l2, descending for ip/cosine."""
    d = pairwise(q, x, metric)
    return torch.topk(d, k, dim=1, largest=metric in _DESCENDING, sorted=True)
