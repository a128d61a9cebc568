"""Batched IVF probed scan: rank buckets, score the probed buckets in
place, select the top k.

Port of ``image_search_engine_tpu/ops/ivf_pallas.py``. The packed table is
list-contiguous (nbuckets, cap, d) (index/ivf.py ``_pack``), so a probed
bucket is one contiguous (cap, d) block and no (Q, nprobe*cap, d) gather
buffer is built. Pad slots inside a bucket carry +inf norms and finite
rows, so they score +inf and never win: validity rides in data, as the
flat store's pad poisoning.

``probed_scan`` is a hand-written CUDA kernel (``csrc/ivf_probed_scan.cu``)
with its plain PyTorch version ``probed_scan_ref`` beside it; the wrapper
runs the plain version only for CPU tensors and launches the kernel or
raises for CUDA tensors, counting launches in ``probed_scan.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _DTYPE_CODES, _SMEM_BYTES, _on_cuda, _stream, _vec, select_topt)


def probed_scan(q: torch.Tensor, packed: torch.Tensor, packed_norms: torch.Tensor,
                probe: torch.Tensor) -> torch.Tensor:
    """Scores ``packed_norms[b, r] - 2 q.packed[b, r]`` for every row r of
    each query's probed buckets: q (Q, d) in the table dtype, packed
    (nbuckets, cap, d) f32 or bf16, packed_norms (nbuckets, cap) f32 (+inf
    at pad slots), probe (Q, P) int32 bucket ids -> (Q, P*cap) f32; column
    p*cap + r is row r of bucket probe[:, p]. A probe id < 0 scores +inf.

    Replaces ``_probed_scan_kernel`` (image_search_engine_tpu/ops/
    ivf_pallas.py:36, launched :153). What bounds it on the card: the
    probed bytes, each distinct probed bucket's cap*d*itemsize, read from
    scattered contiguous blocks; at Q = 1 the 2*cap*d flops per probe are
    far below the f32 rate, so it is a memory-bandwidth kernel. The design:
    no padding or copy (the TPU wrapper padded cap and d to 128; here the
    kernel masks the ragged edge), each bucket is split over blocks of 32
    rows (4 per warp) so that Q = 1 with a handful of probes still puts
    ~40 blocks per probe on the SMs, and each row is scored by the flat
    search's per-row routine (csrc/scoring.cuh: 16-byte loads, f32 fmaf).
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
    with torch.cuda.device(q.device):
        err = _kernels.library().ise_probed_scan(
            _DTYPE_CODES[packed.dtype], q.data_ptr(), packed.data_ptr(),
            packed_norms.data_ptr(), probe.data_ptr(), out.data_ptr(), nq, nprobe, nb, cap,
            d, _vec(packed.view(nb * cap, d)), _stream(q))
    _kernels.check(err, "probed_scan")
    probed_scan.launches += 1
    return out


probed_scan.launches = 0


def probed_scan_ref(q: torch.Tensor, packed: torch.Tensor, packed_norms: torch.Tensor,
                    probe: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`probed_scan`: gather the probed buckets,
    batched f32 matmul."""
    nq, nprobe = probe.shape
    cap = packed.shape[1]
    valid = probe >= 0
    safe = probe.long().clamp(min=0)
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
