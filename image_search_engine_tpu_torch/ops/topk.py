"""Certified two-phase exact top-k — the flat search's hot op.

Port of ``image_search_engine_tpu/ops/topk_pallas.py`` (``topk_twophase``,
``topk_twophase_safe``) for f32 and bf16 stores:

  1. ``groupmin``: scores norms - 2 q.x against every store row and keeps
     the min of each 128-row group, (Q, ngroups);
  2. ``select_topt``: per query, the t = k + margin groups with the
     smallest mins, ascending, ties to the lowest group id;
  3. ``rescore``: scores every row of those t groups, (Q, t*128);

then a ``torch.topk`` over the candidates, the id rebuild and the
certificate "k-th final score <= t-th selected group min" (every pruned
group's min is >= that threshold, so True proves no pruned row could beat
the k-th result).

Each of the three steps is a hand-written CUDA kernel
(``csrc/topk_twophase.cu``) with a plain PyTorch version beside it. A
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

Scores live in the "minimize" domain: l2 uses the squared store norms; ip
halves the query and uses zero norms except at rows poisoned with
``PAD_NORM``, so score = -q.x (or ~PAD_NORM on a pad row). The query is cast
to the store dtype before scoring, as the JAX package does.
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.parallel.topk import ip_penalty
from image_search_engine_tpu_torch.utils.unported import not_ported

log = logging.getLogger(__name__)

GROUP = 128  # candidate-group width (rows)
#: dynamic shared memory a kernel block may ask for (H100: 227 KB per block)
_SMEM_BYTES = 200 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def num_groups(n: int) -> int:
    return -(-n // GROUP)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors are on a CUDA device (launch the kernel),
    False when they are on the CPU (run the plain version)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no two-phase kernel for device {dev}")


def _check_scoring_args(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise not_ported(f"store dtype {x.dtype}", "int8")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if q.dtype != x.dtype:
        raise ValueError(f"query dtype {q.dtype} must equal the store dtype {x.dtype}")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (x.shape[0],):
        raise ValueError("norms must be float32 of shape (N,)")
    for name, t in (("q", q), ("x", x), ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(x: torch.Tensor) -> int:
    """Store elements per 16-byte load, or 1 when rows are not 16-byte aligned."""
    per = 16 // x.element_size()
    return per if x.shape[1] % per == 0 and x.data_ptr() % 16 == 0 else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# Phase 1: group mins
# ---------------------------------------------------------------------------


def groupmin(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Per query, the min of norms[r] - 2 q.x[r] over each 128-row group:
    (Q, ngroups) f32, query-major. Rows of the ragged last group past N
    count as +inf. ``q`` is already in the store dtype (and halved for ip).

    Replaces ``_groupmin_kernel`` (image_search_engine_tpu/ops/
    topk_pallas.py:252). What bounds it on the card: it streams the whole
    store once per call, N*d*itemsize bytes, while at serving batch sizes
    (Q <= 8) its 2*Q*N*d flops are far below the card's f32 rate, so it is
    a memory-bandwidth kernel. The design streams each row with 16-byte
    loads, keeps up to 8 queries in shared memory per block so one read of
    a row serves all of them, and orders blocks so the query tiles of one
    group run back to back and find the group in L2. No store padding or
    copy: the kernel masks the ragged edge itself.
    """
    _check_scoring_args(q, x, norms)
    if not _on_cuda(q, x, norms):
        return groupmin_ref(q, x, norms)
    nq, d = q.shape
    n = x.shape[0]
    qt = next((t for t in (1, 2, 4, 8) if t >= min(nq, 8)), 8)
    while qt > 1 and qt * d * 4 > _SMEM_BYTES:
        qt //= 2
    if d * 4 > _SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory query tile")
    out = torch.empty((nq, num_groups(n)), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_groupmin(
            _DTYPE_CODES[x.dtype], q.data_ptr(), norms.data_ptr(), x.data_ptr(),
            out.data_ptr(), nq, n, d, qt, _vec(x), _stream(x))
    _kernels.check(err, "groupmin")
    groupmin.launches += 1
    return out


groupmin.launches = 0


def groupmin_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin`: one f32 matmul, pad, group min."""
    n = x.shape[0]
    ng = num_groups(n)
    scores = norms[None, :] - 2.0 * (q.float() @ x.float().T)
    scores = F.pad(scores, (0, ng * GROUP - n), value=float("inf"))
    return scores.view(q.shape[0], ng, GROUP).amin(dim=2)


# ---------------------------------------------------------------------------
# Candidate select
# ---------------------------------------------------------------------------


def select_topt(mins: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query, the t smallest group mins in ascending (value, group id)
    order: (vals (Q, t) f32, ids (Q, t) int32). Ties go to the lowest group
    id; vals[:, t-1] is the certificate threshold.

    Replaces ``_select_topt_kernel`` (topk_pallas.py:361, via
    ``_select_topt`` :392). What bounds it on the card: it reads only the
    (Q, ngroups) mins, 1/(128*d) of the store, but t passes over a row are
    serial, so at Q = 1 its time is t block-wide reductions on one SM
    (latency, not bandwidth). The design gives each query one block of up
    to 1024 threads and replaces the TPU kernel's retire-by-+inf scratch
    copy with a lexicographic "after the previous winner" filter, so a
    pass needs one read of the row and two barriers.
    """
    nq, ng = mins.shape
    if not 0 < t <= ng:
        raise ValueError(f"t={t} outside (0, ngroups={ng}]")
    if mins.dtype != torch.float32 or not mins.is_contiguous():
        raise ValueError("mins must be contiguous float32")
    if not _on_cuda(mins):
        return select_topt_ref(mins, t)
    vals = torch.empty((nq, t), dtype=torch.float32, device=mins.device)
    ids = torch.empty((nq, t), dtype=torch.int32, device=mins.device)
    if nq == 0:
        return vals, ids
    with torch.cuda.device(mins.device):
        err = _kernels.library().ise_select_topt(
            mins.data_ptr(), vals.data_ptr(), ids.data_ptr(), nq, ng, t, _stream(mins))
    _kernels.check(err, "select_topt")
    select_topt.launches += 1
    return vals, ids


select_topt.launches = 0


def select_topt_ref(mins: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`select_topt`: a stable ascending sort is the
    (value, id) order of the extract-min passes, ties included."""
    vals, ids = torch.sort(mins, dim=1, stable=True)
    return vals[:, :t].contiguous(), ids[:, :t].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Phase 2: candidate rescore
# ---------------------------------------------------------------------------


def rescore(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
            cand: torch.Tensor) -> torch.Tensor:
    """Scores norms[r] - 2 q.x[r] for every row r of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32; column j*128 + i
    is row cand[:, j]*128 + i. Rows past N score +inf.

    Replaces ``_fused_rescore_kernel`` (topk_pallas.py:298, launched at
    :775). What bounds it on the card: the gathered bytes, Q*t*128*d*
    itemsize, read from scattered 128-row blocks; at Q = 1 that is a few
    dozen blocks, so the design splits each group over 4 blocks (32 rows,
    4 per warp) to put more SMs on the gather, reads each block in place
    from the store (no (Q, t*128, d) gather buffer), and scores with the
    same per-row routine as phase 1, so a group's phase-1 min is bit for
    bit the min of its phase-2 scores.
    """
    _check_scoring_args(q, x, norms)
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError("cand must be int32 of shape (Q, t)")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous")
    if not _on_cuda(q, x, norms, cand):
        return rescore_ref(q, x, norms, cand)
    nq, d = q.shape
    t = cand.shape[1]
    if d * 4 > _SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory query row")
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0 or t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_rescore(
            _DTYPE_CODES[x.dtype], q.data_ptr(), norms.data_ptr(), x.data_ptr(),
            cand.data_ptr(), out.data_ptr(), nq, x.shape[0], d, t, _vec(x), _stream(x))
    _kernels.check(err, "rescore")
    rescore.launches += 1
    return out


rescore.launches = 0


def rescore_ref(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor,
                cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore`: gather the candidate rows, batched
    f32 matmul."""
    n = x.shape[0]
    nq, t = cand.shape
    rows = (cand.long()[:, :, None] * GROUP
            + torch.arange(GROUP, device=cand.device)).reshape(nq, t * GROUP)
    valid = (rows >= 0) & (rows < n)
    safe = rows.clamp(0, max(n - 1, 0))
    xs = x[safe.reshape(-1)].float().view(nq, t * GROUP, -1)
    cross = torch.bmm(xs, q.float()[:, :, None])[:, :, 0]
    scores = norms[safe] - 2.0 * cross
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


KERNELS = (groupmin, select_topt, rescore)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def topk_twophase(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    t_margin: int = 4,
    with_certificate: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Exact k-NN via group-min sweep + candidate rescore. Same contract as
    ``ops.distances.topk_flat``: (distances (Q, k), ids (Q, k) int64),
    ascending for l2, descending for ip/cosine; with ``with_certificate``
    a third output, bool (Q,), True where the result is provably exact.

    ``x`` is an f32 or bf16 store (N, d); ``x_norms`` its squared norms,
    PAD_NORM on padding rows (index/store.py), computed from x when absent
    (l2) or taken as zeros (ip). t = min(k + t_margin, ngroups); when
    t == ngroups every group is rescored and the select does not run.
    """
    if x.dtype not in _DTYPE_CODES:
        raise not_ported(f"store dtype {x.dtype}", "int8")
    if metric == "cosine":
        q = l2_normalize(q.float())
        x = l2_normalize(x.float()).to(x.dtype)
        metric = "ip"
    if metric not in ("l2", "ip"):
        raise ValueError(f"unsupported metric {metric!r}")
    nq = q.shape[0]
    n = x.shape[0]
    ng = num_groups(n)
    qf = q.to(x.dtype).contiguous()
    if metric == "l2":
        norms = x_norms if x_norms is not None else (x.float() * x.float()).sum(1)
    else:
        norms = (torch.zeros(n, dtype=torch.float32, device=x.device) if x_norms is None
                 else ip_penalty(x_norms))
        qf = qf * 0.5
    norms = norms.to(torch.float32).contiguous()

    mins = groupmin(qf, x, norms)
    t = min(k + t_margin, ng)
    if t < ng:
        sel_vals, cand = select_topt(mins, t)
        threshold = sel_vals[:, t - 1]
    else:  # every group is a candidate: nothing pruned, certificate trivially True
        cand = torch.arange(ng, dtype=torch.int32, device=x.device).expand(nq, ng).contiguous()
        threshold = torch.full((nq,), float("inf"), device=x.device)
    scores = rescore(qf, x, norms, cand)

    kk = min(k, t * GROUP)
    vals, pos = torch.topk(scores, kk, dim=1, largest=False, sorted=True)
    flat_ids = (cand.long()[:, :, None] * GROUP
                + torch.arange(GROUP, device=x.device)).reshape(nq, t * GROUP)
    ids = torch.gather(flat_ids, 1, pos)
    extra = ()
    if with_certificate:
        extra = (vals.amax(dim=1) <= threshold,)
    if metric == "l2":
        qnorm = (q.float() * q.float()).sum(1, keepdim=True)
        return (torch.clamp(vals + qnorm, min=0.0), ids) + extra
    return (-vals, ids) + extra  # ip: scores are penalty - q.x


def topk_twophase_safe(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    t_margin: int = 4,
    wide_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_twophase`` with the certificate enforced: if any query's
    certificate fails, the whole call re-runs once at ``wide_margin`` and
    logs; a failure there too is logged as an error, never looped on."""
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms,
                               t_margin=t_margin, with_certificate=True)
    if bool(cert.all()):
        return d, i
    log.warning(
        "top-k exactness certificate failed for %d/%d queries at margin %d; "
        "re-running at margin %d",
        int((~cert).sum()), cert.shape[0], t_margin, wide_margin)
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms,
                               t_margin=wide_margin, with_certificate=True)
    if not bool(cert.all()):
        log.error("certificate still failing at margin %d (%d queries)",
                  wide_margin, int((~cert).sum()))
    return d, i
