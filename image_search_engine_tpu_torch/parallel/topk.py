"""Exact top-k honoring poisoned pad norms, on one device or a mesh.

Port of ``image_search_engine_tpu/parallel/topk.py``: ``PAD_NORM``,
``CHI2_CHUNK``, ``_chi2_topk_chunked``, ``local_topk_with_norms`` and the
sharded search ``distributed_topk``. Each shard scans its (N/S, d) block
with the local search (on the card, the certified two-phase kernels),
then the (dist, global id) candidates merge with one stable top-k, first
over this process's shards on its home device (:func:`process_topk`), then
over the processes (:func:`merge_processes`, one all_gather). Ties go to
the lowest global id, as ``lax.top_k`` over the concatenation in the JAX
package, and merging in two stages keeps the one-stage answer.

Padding protocol: the store is padded to a multiple of the mesh size with
zero rows whose cached norm is poisoned to PAD_NORM (index/store.py), so
pad rows never win: validity is carried in data.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from image_search_engine_tpu_torch.ops.distances import (
    pairwise_chi2,
    stable_largest,
    stable_smallest,
    stable_topk,
)
from image_search_engine_tpu_torch.parallel.mesh import Mesh, all_gather_processes

PAD_NORM = 1e30  # poisoned squared norm marking padded store rows

#: store rows per chi2 scan chunk (memory high-water = Q * CHI2_CHUNK * d
#: elementwise temporaries instead of the full (Q, N, d))
CHI2_CHUNK = 4096


def ip_penalty(norms: torch.Tensor) -> torch.Tensor:
    """The ip search's per-row norms: PAD_NORM on poisoned rows, 0 on real
    ones (real norms must not shift inner-product scores)."""
    return torch.where(norms >= PAD_NORM / 2, torch.full_like(norms, PAD_NORM),
                       torch.zeros_like(norms))


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
    for any k, whose certificate is True by construction; its ties go to the
    lowest row id, as ``lax.top_k`` in the JAX package. For an int8 store
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
        vals, idx = stable_smallest(s, k)
        qn = (q * q).sum(1, keepdim=True)
        return (torch.clamp(vals + qn, min=0.0), idx) + exact
    if metric == "ip":
        vals, idx = stable_largest(cross - ip_penalty(norms)[None, :], k)
        return (vals, idx) + exact
    raise ValueError(f"unsupported metric {metric!r} (cosine: normalize first)")


def process_topk(
    q: torch.Tensor,
    x_shards: Sequence[torch.Tensor],
    norms_shards: Sequence[torch.Tensor],
    k: int,
    metric: str,
    mesh: Mesh,
    use_kernels: bool,
    scales_shards: Optional[Sequence[torch.Tensor]] = None,
    with_certificate: bool = False,
    t_margin: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """This process's half of :func:`distributed_topk`: each local shard's
    top-``min(k, rows per shard)`` by :func:`local_topk_with_norms`, its
    ids offset to global int32 ids, merged on ``mesh.home`` to the best
    ``min(k_final, candidates)`` (k_final as in :func:`distributed_topk`);
    with ``with_certificate`` the AND of the shards' certificates."""
    r = x_shards[0].shape[0]
    k_local = min(k, r)
    k_final = min(k, mesh.size * k_local)
    home = mesh.home
    ds, ids, certs = [], [], []
    for s, (x, norms) in enumerate(zip(x_shards, norms_shards)):
        out = local_topk_with_norms(
            q.to(x.device), x, norms, k_local, metric, use_kernels,
            scales=None if scales_shards is None else scales_shards[s],
            with_certificate=with_certificate, t_margin=t_margin)
        ds.append(out[0].to(home))
        ids.append((out[1] + (mesh.first_shard + s) * r).to(torch.int32).to(home))
        if with_certificate:
            certs.append(out[2].to(home))
    d_cat, i_cat = torch.cat(ds, 1), torch.cat(ids, 1)
    vals, pos = stable_topk(d_cat, min(k_final, d_cat.shape[1]), largest=metric == "ip")
    res = (vals, torch.gather(i_cat, 1, pos))
    if with_certificate:
        res += (torch.stack(certs).all(0),)
    return res


def merge_processes(out: Tuple[torch.Tensor, ...], mesh: Mesh, k: int,
                    descending: bool) -> Tuple[torch.Tensor, ...]:
    """The cross-process half of a sharded search: ``out`` = (d (Q, w),
    int32 ids (Q, w)[, extra]) merged over this process's shards, gathered
    from every process in rank order (global shard order) with one
    all_gather, and merged to the best ``k``. An extra (Q,) bool (the
    certificate) is AND-ed over the processes; an extra (Q, w) bool (the
    probed families' slot validity) rides with its candidates. Without a
    process group, ``out`` as it is."""
    if mesh.group is None:
        return out
    d, i = out[0], out[1]
    nq, w = d.shape
    parts = [d.float(), i.to(torch.int32).view(torch.float32)]
    if len(out) > 2:
        parts.append(out[2].to(torch.float32).reshape(nq, -1))
    gathered = torch.stack(all_gather_processes(torch.cat(parts, 1), mesh))  # (P, Q, cols)
    d_all = gathered[:, :, :w].permute(1, 0, 2).reshape(nq, -1)
    i_all = gathered[:, :, w:2 * w].contiguous().view(torch.int32).permute(1, 0, 2).reshape(nq, -1)
    vals, pos = stable_topk(d_all, min(k, d_all.shape[1]), largest=descending)
    res = (vals, torch.gather(i_all, 1, pos))
    if len(out) > 2:
        extra = gathered[:, :, 2 * w:]
        if out[2].dim() == 1:  # per query: AND over the processes
            res += (extra[:, :, 0].min(0).values > 0,)
        else:
            res += (torch.gather(extra.permute(1, 0, 2).reshape(nq, -1), 1, pos) > 0,)
    return res


def distributed_topk(
    q: torch.Tensor,
    x_shards: Sequence[torch.Tensor],
    norms_shards: Sequence[torch.Tensor],
    k: int,
    metric: str,
    mesh: Mesh,
    use_kernels: bool | None = None,
    scales_shards: Optional[Sequence[torch.Tensor]] = None,
    with_certificate: bool = False,
    t_margin: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Exact k-NN over a row-sharded store.

    Args:
      q: (Q, d) queries.
      x_shards: this process's (N/S, d) blocks of the padded (N, d) store,
        each on its shard's device (parallel/mesh.shard_rows).
      norms_shards: their squared norms, PAD_NORM at padding rows.
      k: neighbours.
      metric: "l2" | "ip" | "chi2" (cosine: normalize rows and queries,
        then "ip").
      mesh: the 1-D mesh.
      use_kernels: the certified two-phase search per shard (default: on
        a CUDA mesh); chi2 always scans in plain chunks.
      scales_shards: per-row dequant scales of an int8 store, sharded like
        the rows.
    Returns:
      (distances (Q, k'), global int32 ids (Q, k')[, certificate (Q,)]) on
      ``mesh.home``, k' = min(k, S * min(k, N/S)); the certificate is True
      where every shard's local top-k was certified (a lost local
      neighbour can be a lost global one).
    """
    if use_kernels is None:
        use_kernels = mesh.home.type == "cuda"
    if metric == "chi2":
        use_kernels = False
    out = process_topk(q, x_shards, norms_shards, k, metric, mesh, use_kernels,
                       scales_shards, with_certificate, t_margin)
    k_final = min(k, mesh.size * min(k, x_shards[0].shape[0]))
    return merge_processes(out, mesh, k_final, descending=metric == "ip")
