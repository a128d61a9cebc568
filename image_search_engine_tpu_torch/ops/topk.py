"""Certified two-phase exact top-k — the flat search's hot op.

Port of ``image_search_engine_tpu/ops/topk_pallas.py`` (``topk_twophase``,
``topk_twophase_safe``, ``quantize_store_int8``, and ``topk_pallas`` as
:func:`topk_running`: one pass with running top-k accumulators,
``csrc/topk_running.cu``) for f32, bf16 and int8 stores:

  1. ``groupmin``: scores norms - 2 q.x against every store row and keeps
     the min of each 128-row group, (Q, ngroups);
  2. ``select_topt``: per query, the t = k + margin groups with the
     smallest mins, ascending, ties to the lowest group id;
  3. ``rescore``: scores every row of those t groups, (Q, t*128);

then a stable sort over the candidates (ties to the lowest candidate
position, i.e. the earlier selected group, as ``lax.top_k``), the id
rebuild and the certificate "k-th final score <= t-th selected group min"
(every pruned group's min is >= that threshold, so True proves no pruned
row could beat the k-th result). An int8 store runs ``groupmin_q8`` and
``rescore_q8`` in steps 1 and 3: the query is quantized per row like the
store, the int8 x int8 products are exact int32 sums, and the per-row
scales fold into an f32 epilogue.

Each step is a hand-written CUDA kernel (``csrc/topk_twophase.cu``,
``csrc/topk_twophase_q8.cu``) with a plain PyTorch version beside it. A
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

Scores live in the "minimize" domain: l2 uses the squared store norms; ip
halves the query (int8: its scale) and uses zero norms except at rows
poisoned with ``PAD_NORM``, so score = -q.x (or ~PAD_NORM on a pad row). The
query is cast to the store dtype (int8: quantized) before scoring, as the
JAX package does.
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.distances import l2_normalize, stable_smallest
from image_search_engine_tpu_torch.parallel.topk import ip_penalty

log = logging.getLogger(__name__)

GROUP = 128  # candidate-group width (rows)
#: dynamic shared memory a kernel block may ask for (H100: 227 KB per block)
_SMEM_BYTES = 200 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: int8 rows wider than this could overflow the int32 sum (127^2 * d >= 2^31)
MAX_Q8_DIM = 133_000
#: store rows per float64 product in the int8 plain versions (bounds the copy)
_Q8_REF_ROWS = 1 << 14


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
        raise ValueError(f"store dtype must be float32 or bfloat16, got {x.dtype} "
                         "(an int8 store is scored by the _q8 kernels)")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if q.dtype != x.dtype:
        raise ValueError(f"query dtype {q.dtype} must equal the store dtype {x.dtype}")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (x.shape[0],):
        raise ValueError("norms must be float32 of shape (N,)")
    for name, t in (("q", q), ("x", x), ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_q8_args(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                   scales: torch.Tensor, norms: torch.Tensor) -> None:
    if q.dtype != torch.int8 or x.dtype != torch.int8:
        raise ValueError(f"want int8 query and store codes, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    if q.shape[1] >= MAX_Q8_DIM:
        raise ValueError(f"d={q.shape[1]} could overflow the int32 product (d < {MAX_Q8_DIM})")
    for name, t, n in (("qscale", qscale, q.shape[0]), ("scales", scales, x.shape[0]),
                       ("norms", norms, x.shape[0])):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},)")
    for name, t in (("q", q), ("qscale", qscale), ("x", x), ("scales", scales),
                    ("norms", norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(x: torch.Tensor) -> int:
    """Store elements per 16-byte load, or 1 when rows are not 16-byte aligned."""
    per = 16 // x.element_size()
    return per if x.shape[1] % per == 0 and x.data_ptr() % 16 == 0 else 1


def _vec_q8(q: torch.Tensor, x: torch.Tensor) -> int:
    """16 when the int8 store and query rows are 16-byte aligned, else 1."""
    return 16 if _vec(x) == 16 and q.data_ptr() % 16 == 0 else 1


def _query_tile(nq: int, row_bytes: int) -> int:
    """Queries per phase-1 block: 1, 2, 4 or 8, as many as the batch fills,
    halved until their rows fit the shared-memory budget."""
    qt = next(t for t in (1, 2, 4, 8) if t >= min(nq, 8))
    while qt > 1 and qt * row_bytes > _SMEM_BYTES:
        qt //= 2
    if row_bytes > _SMEM_BYTES:
        raise ValueError(f"a {row_bytes}-byte query row exceeds the kernels' shared-memory tile")
    return qt


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
    qt = _query_tile(nq, d * 4)
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
# int8 store: quantization and phase 1
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: (codes (N, d) int8, scales (N,)
    f32) with x ~= codes * scales[:, None]. The JAX package's formula, bit
    for bit: scale = max(amax, 1e-12) / 127 in f32, codes = clip(round(x /
    scale), -127, 127) with a true division and round half to even."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=1), min=1e-12)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale


def _epilogue_q8(cross: torch.Tensor, qscale: torch.Tensor, scales: torch.Tensor,
                 norms: torch.Tensor) -> torch.Tensor:
    """norms - cross * ((2 qscale) * scales), each step rounded once in f32,
    in the JAX kernels' order (the CUDA kernels round the same steps)."""
    return norms - cross * ((2.0 * qscale) * scales)


def groupmin_q8(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                scales: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Per query, the min over each 128-row group of norms[r] - f32(q.x[r])
    * ((2 qscale) * scales[r]), where q.x[r] is the exact int32 product of
    the int8 query and store codes: (Q, ngroups) f32, query-major. Rows of
    the ragged last group past N count as +inf. ``qscale`` is the query's
    dequant scale (halved for ip).

    Replaces ``_groupmin_kernel_q8`` (image_search_engine_tpu/ops/
    topk_pallas.py:276, launched :631). What bounds it on the card: it
    streams the store once per call, N*d code bytes plus 8 bytes of norm and
    scale per row, while at serving batch sizes its 2*Q*N*d integer
    operations are far below the card's rate, so it is a memory-bandwidth
    kernel, 4x lighter than the f32 sweep. The design is ``groupmin``'s:
    up to 8 int8 queries in shared memory per block, 16-byte loads of 16
    codes each multiplied with ``__dp4a`` into int32 (a scalar loop for
    rows that are not 16-byte multiples), query tiles of one group back to
    back so they find it in L2. Integer sums are exact in any order, so the
    f32 epilogue, rounded step by step, is the only rounding: the kernel
    equals :func:`groupmin_q8_ref` bit for bit.
    """
    _check_q8_args(q, qscale, x, scales, norms)
    if not _on_cuda(q, qscale, x, scales, norms):
        return groupmin_q8_ref(q, qscale, x, scales, norms)
    nq, d = q.shape
    n = x.shape[0]
    qt = _query_tile(nq, d)
    out = torch.empty((nq, num_groups(n)), dtype=torch.float32, device=x.device)
    if nq == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_groupmin_q8(
            q.data_ptr(), qscale.data_ptr(), norms.data_ptr(), scales.data_ptr(), x.data_ptr(),
            out.data_ptr(), nq, n, d, qt, _vec_q8(q, x), _stream(x))
    _kernels.check(err, "groupmin_q8")
    groupmin_q8.launches += 1
    return out


groupmin_q8.launches = 0


def _cross_q8(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 of the exact integer products q.x[r], (Q, N): a float64 matmul of
    the codes (exact below 2^53; an f32 one is not once 127^2 * d > 2^24),
    chunked over store rows."""
    qd = q.double()
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _Q8_REF_ROWS):
        out[:, s:s + _Q8_REF_ROWS] = (qd @ x[s:s + _Q8_REF_ROWS].double().T).float()
    return out


def groupmin_q8_ref(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor,
                    scales: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`groupmin_q8`: exact product, f32 epilogue,
    pad, group min."""
    n = x.shape[0]
    ng = num_groups(n)
    scores = _epilogue_q8(_cross_q8(q, x), qscale[:, None], scales[None, :], norms[None, :])
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
    _check_cand(cand, q.shape[0])
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
    nq, t = cand.shape
    valid, safe = _candidate_rows(cand, x.shape[0])
    xs = x[safe.reshape(-1)].float().view(nq, t * GROUP, -1)
    cross = torch.bmm(xs, q.float()[:, :, None])[:, :, 0]
    scores = norms[safe] - 2.0 * cross
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


def _candidate_rows(cand: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, safe) (Q, t*128): which candidate-group rows exist, and
    their row ids clamped into the store."""
    nq, t = cand.shape
    rows = (cand.long()[:, :, None] * GROUP
            + torch.arange(GROUP, device=cand.device)).reshape(nq, t * GROUP)
    return (rows >= 0) & (rows < n), rows.clamp(0, max(n - 1, 0))


def _check_cand(cand: torch.Tensor, nq: int) -> None:
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[0] != nq:
        raise ValueError("cand must be int32 of shape (Q, t)")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous")


def rescore_q8(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
               norms: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """:func:`groupmin_q8`'s score for every row r of each query's candidate
    groups: cand (Q, t) int32 group ids -> (Q, t*128) f32; column j*128 + i
    is row cand[:, j]*128 + i. Rows past N score +inf.

    Replaces ``_fused_rescore_kernel_q8`` (topk_pallas.py:333, launched at
    :756). What bounds it on the card: the gathered bytes, Q*t*128*(d + 8),
    read from scattered 128-row blocks; at Q = 1 that is a few dozen blocks
    and launch latency dominates. The design is ``rescore``'s (each group
    split over 4 blocks, blocks read in place, no gather buffer), and it
    scores a row with the same routine as :func:`groupmin_q8`, so a group's
    phase-1 min is bit for bit the min of its phase-2 scores.
    """
    _check_q8_args(q, qscale, x, scales, norms)
    _check_cand(cand, q.shape[0])
    if not _on_cuda(q, qscale, x, scales, norms, cand):
        return rescore_q8_ref(q, qscale, x, scales, norms, cand)
    nq, d = q.shape
    t = cand.shape[1]
    out = torch.empty((nq, t * GROUP), dtype=torch.float32, device=x.device)
    if nq == 0 or t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_rescore_q8(
            q.data_ptr(), qscale.data_ptr(), norms.data_ptr(), scales.data_ptr(), x.data_ptr(),
            cand.data_ptr(), out.data_ptr(), nq, x.shape[0], d, t, _vec_q8(q, x), _stream(x))
    _kernels.check(err, "rescore_q8")
    rescore_q8.launches += 1
    return out


rescore_q8.launches = 0


def rescore_q8_ref(q: torch.Tensor, qscale: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
                   norms: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rescore_q8`: per query, gather the candidate
    rows, exact float64 product, f32 epilogue."""
    valid, safe = _candidate_rows(cand, x.shape[0])
    cross = torch.empty(safe.shape, dtype=torch.float32, device=x.device)
    for i in range(q.shape[0]):
        cross[i] = (x[safe[i]].double() @ q[i].double()).float()
    scores = _epilogue_q8(cross, qscale[:, None], scales[safe], norms[safe])
    return torch.where(valid, scores, torch.full_like(scores, float("inf")))


# ---------------------------------------------------------------------------
# Running-accumulator exact top-k
# ---------------------------------------------------------------------------

#: neighbours the running and merged top-k kernels return at most (as the
#: TPU kernels)
KERNEL_MAX_K = 128
#: scan blocks the running top-k aims for per SM (a few waves, long slices)
_RUNNING_BLOCKS_PER_SM = 8
#: warps per scan block (``WARPS`` in csrc/scoring.cuh)
_RUNNING_WARPS = 8


def _running_slices(n: int, k: int, nqt: int, sms: int) -> int:
    """Store slices per query tile: enough blocks for a few waves over the
    SMs, but at least k rows for each warp of a slice, so the slices' lists
    stay small next to the store."""
    want = -(-_RUNNING_BLOCKS_PER_SM * sms // nqt)
    return max(1, min(want, n // (_RUNNING_WARPS * k)))


def topk_running(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by one pass over the store with running top-k
    accumulators: (distances (Q, k) f32, ids (Q, k) int64), ascending for
    l2, descending for ip and cosine; ties go to the lowest id. When k > N
    the tail is (+inf, -1) for l2 and (-inf, -1) for ip and cosine.

    Counterpart of the JAX package's ``topk_pallas``. ``x`` is an f32 or
    bf16 store; the query stays f32 over either (the products are f32,
    bf16 rows widened exactly), unlike :func:`topk_twophase`, which casts it
    to the store dtype. ``x_norms`` as in :func:`topk_twophase` (ip keeps
    only their PAD_NORM poisoning). k <= 128.

    Replaces ``_topk_kernel`` (image_search_engine_tpu/ops/topk_pallas.py:
    79, launched :211). What bounds it on the card: one read of the store
    per query tile of up to 8 queries, N*d*itemsize + 4N bytes, so at
    serving batch sizes a memory-bandwidth kernel like :func:`groupmin`.
    The design (``csrc/topk_running.cu``) splits the store into slices, one
    block per (slice, query tile); each warp keeps its own sorted top-k per
    query in registers and inserts a row only when it beats the warp's k-th
    (the TPU kernel's reject-fast test, per row); the block merges its
    warps' lists, and a second kernel merges the slices' lists per query.
    """
    qf, x, norms, metric, q = _running_inputs(q, x, k, metric, x_norms)
    if not _on_cuda(qf, x, norms):
        vals, ids = _running_ref_core(qf, x, norms, k)
        return _finish_scores(vals, ids, q, metric)
    nq, d = qf.shape
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"N={n} rows: the running top-k kernel takes N < 2^31")
    qt = _query_tile(nq, d * 4)
    nqt = -(-nq // qt)
    if nqt > 65535:
        raise ValueError(f"{nq} queries exceed the kernel's grid ({65535 * qt} at most)")
    vals = torch.empty((nq, k), dtype=torch.float32, device=x.device)
    ids = torch.empty((nq, k), dtype=torch.int32, device=x.device)
    if nq == 0:
        return _finish_scores(vals, ids.long(), q, metric)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nslices = _running_slices(n, k, nqt, sms)
    part_v = torch.empty((nq, nslices, k), dtype=torch.float32, device=x.device)
    part_i = torch.empty((nq, nslices, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_topk_running(
            _DTYPE_CODES[x.dtype], qf.data_ptr(), norms.data_ptr(), x.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            nq, n, d, k, qt, nslices, _vec(x), _stream(x))
    _kernels.check(err, "topk_running")
    topk_running.launches += 1
    return _finish_scores(vals, ids.long(), q, metric)


topk_running.launches = 0


def topk_running_ref(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_running`, on any device: an f32 matmul
    and a stable sort on (score, id)."""
    qf, x, norms, metric, q = _running_inputs(q, x, k, metric, x_norms)
    vals, ids = _running_ref_core(qf, x, norms, k)
    return _finish_scores(vals, ids, q, metric)


def _running_inputs(q, x, k, metric, x_norms):
    """(f32 query as scored, store, norms, metric, query for the l2 norm):
    the TPU wrapper's preparation (cosine normalizes both sides, ip halves
    the query and keeps only the PAD_NORM poisoning of the norms)."""
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"k={k} outside [1, {KERNEL_MAX_K}] for the running top-k kernel")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32 or bfloat16, got {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"want q (Q, d) and x (N, d), got {tuple(q.shape)}, {tuple(x.shape)}")
    q, x, metric = _cosine_as_ip(q, x, metric)
    qf = q.float()
    if metric == "ip":
        qf = qf * 0.5
    return qf.contiguous(), x.contiguous(), _search_norms(x, metric, x_norms), metric, q


def _running_ref_core(qf, x, norms, k):
    """The k smallest of norms - 2 q.x per query in (score, id) order, padded
    with (+inf, -1) past N: (vals f32, ids int64)."""
    n = x.shape[0]
    scores = norms[None, :] - 2.0 * (qf @ x.float().T)
    vals, ids = torch.sort(scores, dim=1, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    if k > n:
        vals = F.pad(vals, (0, k - n), value=float("inf"))
        ids = F.pad(ids, (0, k - n), value=-1)
    return vals.contiguous(), ids.contiguous()


KERNELS = (groupmin, select_topt, rescore, groupmin_q8, rescore_q8, topk_running)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _cosine_as_ip(q: torch.Tensor, x: torch.Tensor, metric: str):
    """(q, x, metric) with cosine turned into ip over rows normalized in f32
    (the store rounded back to its dtype); raises on other metrics."""
    if metric == "cosine":
        q = l2_normalize(q.float())
        x = l2_normalize(x.float()).to(x.dtype)
        metric = "ip"
    if metric not in ("l2", "ip"):
        raise ValueError(f"unsupported metric {metric!r}")
    return q, x, metric


def _search_norms(x: torch.Tensor, metric: str, x_norms: torch.Tensor | None,
                  x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The per-row norms the kernels score with, f32 (N,): l2 the squared
    store norms (``x_norms``, or computed; an int8 store's dequantized
    ones), ip zeros except PAD_NORM on the rows ``x_norms`` poisons."""
    if metric == "l2":
        if x_norms is not None:
            norms = x_norms
        elif x_scale is not None:  # the dequantized store's norms
            deq = x.float() * x_scale[:, None]
            norms = (deq * deq).sum(1)
        else:
            norms = (x.float() * x.float()).sum(1)
    else:
        norms = (torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
                 if x_norms is None else ip_penalty(x_norms))
    return norms.to(torch.float32).contiguous()


def _finish_scores(vals: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                   metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores in the minimize domain -> distances in the metric's sign: l2
    adds the f32 query's squared norm (clamped at 0), ip negates."""
    if metric == "l2":
        qnorm = (q.float() * q.float()).sum(1, keepdim=True)
        return torch.clamp(vals + qnorm, min=0.0), ids
    return 0.0 - vals, ids  # ip: scores are penalty - q.x; a zero score gives +0.0, not -0.0


def finish_candidates(q: torch.Tensor, scores: torch.Tensor, cand: torch.Tensor,
                      threshold: torch.Tensor, k: int, metric: str,
                      with_certificate: bool) -> Tuple[torch.Tensor, ...]:
    """The two-phase searches' last step: the k best of the (Q, t*128)
    rescored candidates, their row ids rebuilt from the (Q, t) group ids,
    the distances in the metric's sign, and with ``with_certificate`` the
    certificate "k-th score <= threshold" (the t-th selected group min)."""
    nq, t = cand.shape
    kk = min(k, t * GROUP)
    # positions follow the select's group order, so ties go to the earlier
    # selected group, then the lower row: the JAX package's lax.top_k ids
    vals, pos = stable_smallest(scores, kk)
    flat_ids = (cand.long()[:, :, None] * GROUP
                + torch.arange(GROUP, device=scores.device)).reshape(nq, t * GROUP)
    ids = torch.gather(flat_ids, 1, pos)
    extra = (vals.amax(dim=1) <= threshold,) if with_certificate else ()
    return _finish_scores(vals, ids, q, metric) + extra


def topk_twophase(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    t_margin: int = 4,
    with_certificate: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Exact k-NN via group-min sweep + candidate rescore. Same contract as
    ``ops.distances.topk_flat``: (distances (Q, k), ids (Q, k) int64),
    ascending for l2, descending for ip/cosine; with ``with_certificate``
    a third output, bool (Q,), True where the result is provably exact.

    ``x`` is an f32, bf16 or int8 store (N, d); an int8 store needs its
    per-row dequant scales ``x_scale`` (N,), and the query is then quantized
    per row the same way, so the result is exact over the quantized store
    and quantized query (l2 adds the unquantized query's squared norm).
    ``x_norms`` are the store's squared norms, PAD_NORM on padding rows
    (index/store.py), computed from x when absent (l2) or taken as zeros
    (ip). t = min(k + t_margin, ngroups); when t == ngroups every group is
    rescored and the select does not run.
    """
    is_int8 = x.dtype == torch.int8
    if is_int8 and x_scale is None:
        raise ValueError("int8 store requires x_scale")
    if not is_int8 and x.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype must be float32, bfloat16 or int8, got {x.dtype}")
    if metric == "cosine" and is_int8:
        raise ValueError("pre-normalize rows and use metric='ip' with int8")
    q, x, metric = _cosine_as_ip(q, x, metric)
    nq = q.shape[0]
    ng = num_groups(x.shape[0])
    if is_int8:
        qf, qscale = quantize_int8(q)
        x_scale = x_scale.to(torch.float32).contiguous()
    else:
        qf = q.to(x.dtype).contiguous()
    norms = _search_norms(x, metric, x_norms, x_scale if is_int8 else None)
    if metric == "ip":
        if is_int8:
            qscale = qscale * 0.5  # the epilogue multiplies by 2 * qscale
        else:
            qf = qf * 0.5

    if is_int8:
        mins = groupmin_q8(qf, qscale, x, x_scale, norms)
    else:
        mins = groupmin(qf, x, norms)
    t = min(k + t_margin, ng)
    if t < ng:
        sel_vals, cand = select_topt(mins, t)
        threshold = sel_vals[:, t - 1]
    else:  # every group is a candidate: nothing pruned, certificate trivially True
        cand = torch.arange(ng, dtype=torch.int32, device=x.device).expand(nq, ng).contiguous()
        threshold = torch.full((nq,), float("inf"), device=x.device)
    if is_int8:
        scores = rescore_q8(qf, qscale, x, x_scale, norms, cand)
    else:
        scores = rescore(qf, x, norms, cand)

    return finish_candidates(q, scores, cand, threshold, k, metric, with_certificate)


def topk_twophase_safe(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    x_norms: torch.Tensor | None = None,
    x_scale: torch.Tensor | None = None,
    t_margin: int = 4,
    wide_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_twophase`` with the certificate enforced: if any query's
    certificate fails, the whole call re-runs once at ``wide_margin`` and
    logs; a failure there too is logged as an error, never looped on."""
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms, x_scale=x_scale,
                               t_margin=t_margin, with_certificate=True)
    if bool(cert.all()):
        return d, i
    log.warning(
        "top-k exactness certificate failed for %d/%d queries at margin %d; "
        "re-running at margin %d",
        int((~cert).sum()), cert.shape[0], t_margin, wide_margin)
    d, i, cert = topk_twophase(q, x, k, metric, x_norms=x_norms, x_scale=x_scale,
                               t_margin=wide_margin, with_certificate=True)
    if not bool(cert.all()):
        log.error("certificate still failing at margin %d (%d queries)",
                  wide_margin, int((~cert).sum()))
    return d, i
