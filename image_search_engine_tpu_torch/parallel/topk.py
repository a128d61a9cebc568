"""Single-device exact top-k honoring poisoned pad norms.

Port of the single-device half of ``image_search_engine_tpu/parallel/
topk.py`` (``PAD_NORM``, ``local_topk_with_norms``). The sharded search
(``distributed_topk``) waits for ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.utils.unported import not_ported

PAD_NORM = 1e30  # poisoned squared norm marking padded store rows


def ip_penalty(norms: torch.Tensor) -> torch.Tensor:
    """The ip search's per-row norms: PAD_NORM on poisoned rows, 0 on real
    ones (real norms must not shift inner-product scores)."""
    return torch.where(norms >= PAD_NORM / 2, torch.full_like(norms, PAD_NORM),
                       torch.zeros_like(norms))


def local_topk_with_norms(
    q: torch.Tensor,
    x: torch.Tensor,
    norms: torch.Tensor,
    k: int,
    metric: str,
    use_kernels: bool = False,
    with_certificate: bool = False,
    t_margin: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Exact top-k over one f32/bf16 store whose pad rows carry PAD_NORM.

    ``use_kernels`` runs the certified two-phase search (ops/topk.py: CUDA
    kernels on a CUDA store, their plain versions on the CPU); otherwise a
    plain full scan (one matmul + ``torch.topk``), exact for any k, whose
    certificate is True by construction. Returns distances in the metric's
    natural sign (l2 ascending, ip descending) and row indices.
    """
    if use_kernels:
        from image_search_engine_tpu_torch.ops.topk import topk_twophase

        mkw = {} if t_margin is None else {"t_margin": t_margin}
        return topk_twophase(q, x, k, metric, x_norms=norms,
                             with_certificate=with_certificate, **mkw)
    if metric == "chi2":
        raise not_ported("the chi2 metric", "chi2")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise not_ported(f"store dtype {x.dtype}", "int8")
    exact = (torch.ones(q.shape[0], dtype=torch.bool, device=q.device),) if with_certificate else ()
    q = q.float()
    cross = q @ x.float().T
    if metric == "l2":
        s = norms[None, :] - 2.0 * cross  # pad rows -> ~PAD_NORM
        vals, idx = torch.topk(s, k, dim=1, largest=False, sorted=True)
        qn = (q * q).sum(1, keepdim=True)
        return (torch.clamp(vals + qn, min=0.0), idx) + exact
    if metric == "ip":
        vals, idx = torch.topk(cross - ip_penalty(norms)[None, :], k, dim=1, largest=True,
                               sorted=True)
        return (vals, idx) + exact
    raise ValueError(f"unsupported metric {metric!r} (cosine: normalize first)")
