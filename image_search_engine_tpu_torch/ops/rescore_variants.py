"""The phase-2 candidate rescore's prototype variants (``csrc/rescore_variants.cu``).

Ports of the TPU prototypes under the JAX repo's ``benchmarks/``, each the
production rescore (:func:`~image_search_engine_tpu_torch.ops.topk.rescore`:
every row of each query's candidate 128-row groups scored against it) with
one thing changed:

  * :func:`rescore_gather`: the rows' squared norms come from the gathered
    bf16 rows themselves, not from a norms array (``gather_kernel_proto.py``,
    ``gather_kernel_sweep2.py``);
  * :func:`rescore_cross`: only the raw cross products q.x leave the kernel;
    the caller adds the norms (``rescore_dma_variants.py``).

As in the prototypes, the query and the store are bf16 (f32 sums), and the
output is (Q, t*128) f32, column j*128 + r for row cand[:, j]*128 + r. Rows
past N score +inf (gather) or 0 (cross); nothing is padded. Each wrapper
launches its CUDA kernel for CUDA tensors (or raises) and runs its plain
PyTorch version (``*_ref``: a gather, then an f32 batched product) for CPU
tensors, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.topk import (
    _SMEM_BYTES, GROUP, _candidate_rows, _check_cand, _on_cuda, _stream, _vec, num_groups)

#: queries per kernel block, the TPU grid step's QB (gather_kernel_sweep.py:55-57)
QBS = (8, 16, 32)


def _check(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, qb: int) -> None:
    if q.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"want a bf16 query and store, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    for name, t in (("q", q), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_cand(cand, q.shape[0])
    ng = num_groups(x.shape[0])
    if not 0 < cand.shape[1] <= ng:
        raise ValueError(f"t={cand.shape[1]} outside (0, ngroups={ng}]")
    if qb not in QBS:
        raise ValueError(f"qb={qb} not in {QBS}")


def _launch(fn, q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, qb: int) -> torch.Tensor:
    nq, d = q.shape
    t = cand.shape[1]
    if qb * d * 4 > _SMEM_BYTES:
        raise ValueError(f"{qb} query rows of d={d} exceed the kernel's shared-memory tile")
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0:
        return out
    with torch.cuda.device(x.device):
        err = getattr(_kernels.library(), f"ise_{fn.__name__}")(
            q.data_ptr(), x.data_ptr(), cand.data_ptr(), out.data_ptr(), nq, x.shape[0], d, t,
            qb, _vec(x), _stream(x))
    _kernels.check(err, fn.__name__)
    fn.launches += 1
    return out


def rescore_gather(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor,
                   qb: int = 8) -> torch.Tensor:
    """Scores x.x - 2 q.x for every row of each query's candidate groups,
    the squared norm taken from the bf16 row itself: cand (Q, t) int32
    group ids -> (Q, t*128) f32. Rows past N score +inf.

    Replaces ``rescore_kernel`` (benchmarks/gather_kernel_proto.py:49,
    launched :119; the same body at benchmarks/gather_kernel_sweep2.py:40,
    launched :112). What bounds it on the card: the gathered bytes, the
    distinct candidate groups' rows read from scattered 128-row blocks. The
    design gives a block ``qb`` (query, group) pairs of one candidate slot,
    as the TPU grid step, stages the ``qb`` query rows in shared memory as
    f32, and has each half-warp read one row once (16-byte loads where rows
    are aligned) and sum both q.x and x.x in f32.
    """
    _check(q, x, cand, qb)
    if not _on_cuda(q, x, cand):
        return rescore_gather_ref(q, x, cand)
    return _launch(rescore_gather, q, x, cand, qb)


rescore_gather.launches = 0


def rescore_cross(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor,
                  qb: int = 8) -> torch.Tensor:
    """The raw cross products q.x for every row of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32. Rows past N give
    0, as the TPU script's zero-padded store does; its caller adds the
    gathered norms (PAD_NORM past N).

    Replaces ``_cross_only_kernel`` (benchmarks/rescore_dma_variants.py:33,
    launched :109). What bounds it on the card: the gathered bytes, as
    :func:`rescore_gather`, whose design it shares without the x.x sums.
    """
    _check(q, x, cand, qb)
    if not _on_cuda(q, x, cand):
        return rescore_cross_ref(q, x, cand)
    return _launch(rescore_cross, q, x, cand, qb)


rescore_cross.launches = 0


def _gathered(q: torch.Tensor, x: torch.Tensor,
              cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(valid (Q, t*128), the candidate rows widened to f32 (Q, t*128, d),
    their f32 cross products with the query (Q, t*128))."""
    nq, t = cand.shape
    valid, safe = _candidate_rows(cand, x.shape[0])
    xs = x[safe.reshape(-1)].float().view(nq, t * GROUP, -1)
    return valid, xs, torch.bmm(xs, q.float()[:, :, None])[:, :, 0]


def rescore_gather_ref(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_gather`: gather, batched f32 product,
    norms of the gathered rows."""
    valid, xs, cross = _gathered(q, x, cand)
    scores = (xs ** 2).sum(-1) - 2.0 * cross
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


def rescore_cross_ref(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_cross`: gather, batched f32 product."""
    valid, _, cross = _gathered(q, x, cand)
    return torch.where(valid, cross, torch.zeros_like(cross))


KERNELS = (rescore_gather, rescore_cross)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
