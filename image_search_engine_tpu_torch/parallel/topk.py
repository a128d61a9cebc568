"""Single-device exact top-k honoring poisoned pad norms.

Port of the single-device half of ``image_search_engine_tpu/parallel/
topk.py`` (``PAD_NORM``, ``CHI2_CHUNK``, ``_chi2_topk_chunked``,
``local_topk_with_norms``). The sharded search (``distributed_topk``) waits
for ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.ops.distances import pairwise_chi2

PAD_NORM = 1e30  # poisoned squared norm marking padded store rows

#: store rows per chi2 scan chunk (memory high-water = Q * CHI2_CHUNK * d
#: elementwise temporaries instead of the full (Q, N, d))
CHI2_CHUNK = 4096


def ip_penalty(norms: torch.Tensor) -> torch.Tensor:
    """The ip search's per-row norms: PAD_NORM on poisoned rows, 0 on real
    ones (real norms must not shift inner-product scores)."""
    return torch.where(norms >= PAD_NORM / 2, torch.full_like(norms, PAD_NORM),
                       torch.zeros_like(norms))


def stable_smallest(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row in (value, position) order: ties to the
    lowest position, as ``lax.top_k`` of the negated values."""
    v, pos = torch.sort(vals, dim=1, stable=True)
    return v[:, :k], pos[:, :k]


def _chi2_topk_chunked(q: torch.Tensor, x: torch.Tensor, penalty: torch.Tensor, k: int,
                       chunk: int = CHI2_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chi2 top-k over store chunks with a running (Q, k) merge, so
    memory is O(Q * chunk * d) for any N (chi2 has no matmul form). Ties go
    to the lowest row id, as the JAX package's scan."""
    nq = q.shape[0]
    acc_d = torch.full((nq, k), float("inf"), device=q.device)
    acc_i = torch.full((nq, k), -1, dtype=torch.long, device=q.device)
    for s in range(0, x.shape[0], chunk):
        sc = pairwise_chi2(q, x[s:s + chunk]) + penalty[None, s:s + chunk]
        vals, idx = stable_smallest(sc, k)
        acc_d, pos = stable_smallest(torch.cat([acc_d, vals], 1), k)
        acc_i = torch.gather(torch.cat([acc_i, idx + s], 1), 1, pos)
    return acc_d, acc_i


def local_topk_with_norms(
    q: torch.Tensor,
    x: torch.Tensor,
    norms: torch.Tensor,
    k: int,
    metric: str,
    use_kernels: bool = False,
    scales: torch.Tensor | None = None,
    with_certificate: bool = False,
    t_margin: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Exact top-k over one f32/bf16 store, or int8 codes with their per-row
    dequant ``scales``, whose pad rows carry PAD_NORM.

    ``use_kernels`` runs the certified two-phase search (ops/topk.py: CUDA
    kernels on a CUDA store, their plain versions on the CPU); otherwise a
    plain full scan (one matmul, or the chunked chi2 scan, + a top-k), exact
    for any k, whose certificate is True by construction. For an int8 store
    the full scan mirrors the kernels as the JAX package's XLA path does: the
    query round-tripped through the per-row int8 quantization times the
    dequantized store, in f32, with the true query norm for l2. Returns
    distances in the metric's natural sign (l2 and chi2 ascending, ip
    descending) and row indices.
    """
    if use_kernels:
        from image_search_engine_tpu_torch.ops.topk import topk_twophase

        mkw = {} if t_margin is None else {"t_margin": t_margin}
        return topk_twophase(q, x, k, metric, x_norms=norms, x_scale=scales,
                             with_certificate=with_certificate, **mkw)
    exact = (torch.ones(q.shape[0], dtype=torch.bool, device=q.device),) if with_certificate else ()
    q = q.float()
    q_score = q  # the query as the cross term sees it
    if x.dtype == torch.int8:
        from image_search_engine_tpu_torch.ops.topk import quantize_int8

        if scales is None:
            raise ValueError("int8 store requires scales")
        codes, sq = quantize_int8(q)
        q_score = codes.float() * sq[:, None]
        x = x.float() * scales[:, None]
    else:
        x = x.float()
    if metric == "chi2":
        penalty = ip_penalty(norms)
        if x.shape[0] > CHI2_CHUNK:
            return _chi2_topk_chunked(q, x, penalty, k) + exact
        return stable_smallest(pairwise_chi2(q, x) + penalty[None, :], k) + exact
    cross = q_score @ x.T
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
