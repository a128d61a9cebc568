#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

  0. set-up: versions, the card's name and power limit, TF32 off, the
     CUDA kernels built from image_search_engine_tpu_torch/csrc;
  1. each kernel of the two-phase search against its plain PyTorch
     version on the same tensors on the card, through FlatIndex.search
     and the three kernel wrappers directly, with CUDA-event timings: f32
     stores at 1M x 2048 beside cuBLAS's f32 product alone, Q = 1 on CUDA
     cores, Q = 64 and 256 on tensor cores (3xTF32 on the warpgroup MMA,
     both phases) and on CUDA cores, the CUDA-core and the tensor-core
     sweep at Q = 1, 2, 4, 8, 16; bf16 stores on tensor cores (also at 1M
     x 2048, Q = 1 and 64, beside the bf16 product alone and the row_dot
     sweep); edge sweeps of the bf16 and the f32 tensor-core
     kernels' tiles and f32 rows of one sign; every group min equal to the
     min of its rescored rows bit for bit, every certificate true; then the
     select (``select_topt``: the radix select for every t, its selected
     entries sorted by counting up to t = 256, by a bitonic network up to
     4096, by a radix sort in a global scratch beyond) bit-equal to its
     plain version over a sweep of row widths, t (up to W - 1 = 65,535),
     batch sizes and rows (random, tie-heavy, +-0.0, +inf, small entries
     off the sampled positions), timed beside ``torch.topk`` and the
     extract-min kernel it replaced, forced (also bit-equal), at the main
     paths' shapes and at t = 257, 300, 1000 and 4096 (CUDA events around
     each call, and around a CUDA graph's replay for the device's time
     alone);
  2. the flat main path through the user's entry points: 4,096 PNGs
     indexed by the port's indexer CLI (ResNet-50, flat l2, f32 store), the
     port's HTTP server queried with corpus images, and the kernel launch
     counts of that serving run; then a batch of 64 stored embeddings
     through FlatIndex.search (the f32 tensor-core route), and the select on
     the served index's group mins (Q = 1, 32 groups) timed;
  3. IVF-PQ: an IVFPQIndex (nlist 1024, nprobe 4, m 16) built on the card
     over 1,000,000 x 2048 clustered rows, its two kernels (k-means
     assignment, probed scan) and the probed top-k against their plain
     versions, the probed search against ADC and exact search; then the
     IVF-PQ path through the entry points (the same PNGs, indexer CLI with
     ``--index-type ivfpq --pq-rerank 64``, HTTP server) with the launch
     counts of the build and of serving; the assignment (3xTF32 on tensor
     cores) beside cuBLAS's f32 product alone and both bounds; the probed
     scan's two routes (slot by slot, bucket by bucket) bit-equal and timed
     at Q = 1, 64 and 128 (either side of the plan's crossing),
     ``ivf_probed_topk`` at Q = 1 split into its steps; the
     select timed on the probed scan's width at Q = 1 and 64, and searches
     with k = 300 and a rerank shortlist of 1000 on the radix select; then
     batched IVF at the JAX package's point (benchmarks/ivf_batched_1m.py's
     1M x 128 data, IVFIndex nlist 1024, nprobe 4, f32 and bf16 tables, Q =
     1, 32, 64, 256, 1024): search_batched's launches by route, both scan routes
     bit-equal, within tolerance of the plain version and timed beside the
     distinct buckets' byte bound, the probed top-k equal to the plain
     route's;
  4. the int8 store and chi2: quantization on the card bit-identical to the
     numpy formula, the int8 kernels (phase 1 on CUDA cores up to 4 queries,
     on tensor cores beyond) equal to their plain versions bit for bit at Q
     = 1 x 1M x 2048 and three other shapes plus a 118-shape edge sweep,
     with timings (both phase-1 kernels at Q = 1, 4, 8, 16; ``torch._int_mm``'s
     product alone as a yardstick; the rescore with its slots in slot order
     and in group order at Q = 1, 64 and 256, and the group order's kernel);
     then the same PNGs through
     ``--store-dtype int8`` and through ``--index-type chi2``, each served
     over HTTP with its launch counts; after phase 7, phase 1 at bench.py's
     point quantized to int8 (Q = 2048);
  5. the last two package kernels through their entry points:
     ``topk_running`` (running top-k accumulators) at Q = 1 and 8 over 1M x
     2048 f32 and Q = 1 over bf16, ids equal to its plain version's, and
     ``topk_merged`` (the two-phase search in one cooperative launch) at Q =
     1 and 64 over 1M x 2048 f32 and bf16 and at Q = 2048 and 4096 over 1M x
     128 bf16, equal to ``topk_twophase(t_margin=2)`` (bit for bit where
     both score f32 on CUDA cores; where the two-phase search runs on
     tensor cores, bf16 and f32 beyond a few queries, within tolerance, ids
     equal but at near-ties); edge sweeps for both; timings beside the
     two-phase search;
  6. bench.py's operating point (1M x 128 bf16, k = 10): the bench twin
     (``image_search_engine_tpu_torch.bench``) at Q = 4096 over 100
     dispatches, each ported benchmark script's searches once with their
     recall@10 beside the production search's (the prototypes' launches by
     route: none on CUDA cores), then timed in ms per dispatch beside the
     shipped search; the bf16 tensor-core
     kernels against their plain versions at Q = 2048 and 4096, the twin's
     dispatch split into groupmin, select_topt, rescore and the finish,
     the four phase-1 prototype kernels (group width, chunked columns,
     two-level mins in three layouts) against their plain versions at Q =
     2048 and 4096 plus a 46-shape edge sweep, with timings beside
     ``groupmin`` and the bf16 product alone: the width and two-level
     kernels on the tensor-core sweep (width 128 and every layout's group
     mins equal to ``groupmin``'s bit for bit) and on the CUDA-core route
     they replaced, forced (its 128-row mins equal to each other's bit for
     bit, production's within tolerance of them); then the tie order of the
     flat paths over a store whose second half repeats its first, and the
     cost of the k > 128 full scan's stable sort at 1M rows;
  7. the same store: each ported phase-2 prototype script's searches once
     (fused gather and rescore, its QB sweep, the approximate select and Q
     = 4096, cross products only, the hierarchical select) with their
     recall@10 beside the production search's, the three rescore variant
     kernels against their plain versions at Q = 2048 and 4096 on a real
     phase 1's candidates plus an edge sweep, with timings beside the
     production ``rescore``.

Before its last two lines it prints a JSON object describing the 16
kernels (launches, errors, times, bounds; ``groupmin`` and ``rescore``
per store dtype and, for f32, per route; the extract-min select's launches
in each main-path run, which must be 0) and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without CUDA it
exits non-zero before printing any of them.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np

SEED = 0
K = 20
TIMING_REPS = 20
CSRC = "image_search_engine_tpu_torch/csrc/"
SOURCES = {
    "groupmin": CSRC + "topk_twophase.cu",
    "select_topt": CSRC + "select_topt.cu",
    "rescore": CSRC + "topk_twophase.cu",
    "probed_scan": CSRC + "ivf_probed_scan.cu",
    "kmeans_assign": CSRC + "kmeans_assign.cu",
    "groupmin_q8": CSRC + "topk_twophase_q8.cu",
    "rescore_q8": CSRC + "topk_twophase_q8.cu",
    "topk_running": CSRC + "topk_running.cu",
    "topk_merged": CSRC + "topk_merged.cu",
    "groupmin_width": CSRC + "groupmin_width_mma.cu",
    "groupmin_chunked": CSRC + "groupmin_variants.cu",
    "groupmin_two_level": CSRC + "groupmin_two_level_mma.cu",
    "groupmin_two_level_layouts": CSRC + "groupmin_two_level_mma.cu",
    "rescore_gather": CSRC + "rescore_variants.cu",
    "rescore_gather_sweep2": CSRC + "rescore_variants.cu",
    "rescore_cross": CSRC + "rescore_variants.cu",
}
# the f32 tensor-core route: one warpgroup-MMA kernel for both phases
SOURCES_F32_TC = {"groupmin": CSRC + "groupmin_tf32.cu", "rescore": CSRC + "groupmin_tf32.cu"}
# the extract-min kernel (t passes), timed beside the radix select that replaced it
SOURCE_SELECT_EXTRACT_MIN = CSRC + "topk_twophase.cu"
# the CUDA-core width and two-level kernels, timed beside the tensor-core ones that replaced them
SOURCE_VARIANTS_CUDA_CORE = CSRC + "groupmin_variants.cu"
REPLACES = {
    "groupmin": "image_search_engine_tpu/ops/topk_pallas.py:252",
    "select_topt": "image_search_engine_tpu/ops/topk_pallas.py:361",
    "rescore": "image_search_engine_tpu/ops/topk_pallas.py:298",
    "probed_scan": "image_search_engine_tpu/ops/ivf_pallas.py:36",
    "kmeans_assign": "image_search_engine_tpu/ops/kmeans_pallas.py:26",
    "groupmin_q8": "image_search_engine_tpu/ops/topk_pallas.py:276",
    "rescore_q8": "image_search_engine_tpu/ops/topk_pallas.py:333",
    "topk_running": "image_search_engine_tpu/ops/topk_pallas.py:79",
    "topk_merged": "image_search_engine_tpu/ops/topk_merged.py:66",
    "groupmin_width": "benchmarks/rescore_variants2.py:61",
    "groupmin_chunked": "benchmarks/sweep_chunked.py:53",
    "groupmin_two_level": "benchmarks/subgroup_proto.py:39",
    "groupmin_two_level_layouts": "benchmarks/subgroup_variants.py:36",
    "rescore_gather": "benchmarks/gather_kernel_proto.py:49",
    "rescore_gather_sweep2": "benchmarks/gather_kernel_sweep2.py:40",
    "rescore_cross": "benchmarks/rescore_dma_variants.py:33",
}
EPS32 = float(np.finfo(np.float32).eps)
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, tf32, bf16 and int8 on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# phase 3: the repo's 1M IVF operating point at the ResNet-50 width, over
# synthetic rows: 4,096 Gaussian centres in a 64-d latent space, projected
# to 2048-d (the latent width is a choice, not a measured property of image
# embeddings; recalls on this corpus describe this corpus only)
SCALE_N, SCALE_D, SCALE_CENTRES, SCALE_LATENT = 1_000_000, 2048, 4096, 64
NLIST, NPROBE, PQ_M = 1024, 4, 16
# phase 3, batched IVF: the JAX package's point (benchmarks/ivf_batched_1m.py:
# its data, IVFIndex nlist 1024, nprobe 4, k = 10, Q = 64, 256 and 1024),
# Q = 1, and Q = 32, the batch below probed_scan_plan's crossing (Q = 64 the
# one above)
BATCHED_N, BATCHED_D, BATCHED_NLIST, BATCHED_NPROBE, BATCHED_K = 1_000_000, 128, 1024, 4, 10
BATCHED_Q = (1, 32, 64, 256, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Phase 1 helpers
# ---------------------------------------------------------------------------


def median_ms(fn, flush, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm
    run; the L2 cache is flushed before each timed run (a serving call
    finds the candidate blocks cold after phase 1 streamed the store)."""
    import torch

    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def graph_ms(fn, flush, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured in a CUDA
    graph, the L2 cache flushed before each: the device's time for fn's
    launches without the host's time to issue them, which median_ms counts
    where it exceeds the flush's."""
    import torch

    fn()  # built and configured before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return median_ms(graph.replay, flush, reps)


class ReadFlush:
    """An L2 flush by reading a buffer larger than L2 (``flush.zero_()`` in
    median_ms writes one): the lines it leaves are clean, so a kernel timed
    after it does not also pay the write-back of 50 MB of dirty lines, which
    at a few dozen MB of reads doubles a small kernel's traffic."""

    def __init__(self, buf):
        import torch

        self.buf, self.out = buf, torch.empty((), dtype=buf.dtype, device=buf.device)

    def zero_(self):
        import torch

        torch.sum(self.buf, dim=0, out=self.out)


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the peak rate
    for their type."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def score_tol(q, norms) -> float:
    """Tolerance for a kernel score against its plain version: both sum
    d products in f32 in different orders, so they may differ by a few
    ulps of the magnitudes summed, |norm| + 2 |q| |x|."""
    import torch

    valid = norms[norms < 1e29]
    xmax = torch.sqrt(valid.max()).item()
    qmax = q.float().norm(dim=1).max().item()
    return 16 * EPS32 * (valid.max().item() + 2 * qmax * xmax)


def max_abs_err(a, b) -> float:
    """max |a - b| over finite entries; +inf must match +inf exactly."""
    import torch

    inf_a, inf_b = torch.isinf(a), torch.isinf(b)
    if not torch.equal(inf_a, inf_b):
        raise AssertionError("kernel and plain version disagree on +inf (masked) entries")
    if torch.isnan(a).any() or torch.isnan(b).any():
        raise AssertionError("NaN in scores")
    fin = ~inf_a
    return float((a[fin] - b[fin]).abs().max().item()) if fin.any() else 0.0


def assert_same_topk(d, i, rd, ri, tol: float, what: str) -> None:
    """Distances within tol, row for row; an id in both lists passes, and an
    id in one list only passes where its distance lies within tol of that
    list's own k-th distance (a near-tie at the boundary swapped in)."""
    if not np.allclose(d, rd, rtol=0, atol=tol):
        raise AssertionError(f"{what}: distances differ by {np.abs(d - rd).max()} > {tol}")
    for r in range(d.shape[0]):
        for ids, dist, other in ((i[r], d[r], ri[r]), (ri[r], rd[r], i[r])):
            only = ~np.isin(ids, other)
            far = only & (np.abs(dist - dist[-1]) > tol)
            if far.any():
                raise AssertionError(f"{what}: query {r} ids differ beyond ties: "
                                     f"{sorted(ids[far].tolist())[:8]}")


def check_search(name, index, q):
    """FlatIndex.search against a plain full scan that scores the query as
    the kernels do (cast to the store dtype in the cross term); all
    certificates True. Returns (query as searched, kernel query, kernel
    norms, tolerance)."""
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops.distances import l2_normalize
    from image_search_engine_tpu_torch.parallel.topk import ip_penalty, local_topk_with_norms

    store, norms = index.store.vectors, index.store.norms
    metric = "l2" if index.metric == "l2" else "ip"
    qs = l2_normalize(q) if index.metric == "cosine" else q
    di, ii = index.search(q, K)
    qc = qs.to(store.dtype).float()
    rd, ri = local_topk_with_norms(qc, store, norms, K, metric)
    if metric == "l2":  # the search adds the f32 query's own squared norm
        rd = rd + ((qs * qs).sum(1) - (qc * qc).sum(1))[:, None]
    qf, knorms = qs.to(store.dtype), norms
    if metric == "ip":
        qf, knorms = qf * 0.5, ip_penalty(norms)
    tol = score_tol(qf, norms)
    assert_same_topk(di, ii, rd.cpu().numpy(), ri.cpu().numpy(), 2 * tol, f"{name} search")
    _, _, cert = T.topk_twophase(qs, store, K, metric, x_norms=norms, with_certificate=True)
    if not bool(cert.all()):
        raise AssertionError(f"{name}: certificate failed for {int((~cert).sum())} queries")
    return qs, qf, knorms, tol


@contextlib.contextmanager
def f32_kernel(route: str):
    """An f32 store's groupmin and rescore on one of their routes whatever
    the batch size: "cuda" (row_dot on CUDA cores) or "mma" (3xTF32 on the
    warpgroup MMA, for rows of whole 16-byte units; other rows stay on CUDA
    cores); the wrappers pick by ``F32_CUDA_CORE_MAX_Q``, which this sets
    for the duration."""
    from image_search_engine_tpu_torch.ops import topk as T

    keep = T.F32_CUDA_CORE_MAX_Q
    T.F32_CUDA_CORE_MAX_Q = sys.maxsize if route == "cuda" else 0
    try:
        yield
    finally:
        T.F32_CUDA_CORE_MAX_Q = keep


def f32_route(x, nq: int) -> str:
    """The route the wrappers give a batch of nq queries over the f32 store x."""
    from image_search_engine_tpu_torch.ops import topk as T

    return "mma" if T._on_tensor_cores(x, nq) else "cuda"


@contextlib.contextmanager
def select_route(route: str):
    """select_topt on one of its routes: "extract_min" (t passes, the TPU
    kernel's algorithm, which the radix select replaced for every t; no
    search path takes it) or "radix" (every plan of select_plan); this
    swaps ``select_plan`` for the duration."""
    from image_search_engine_tpu_torch.ops import topk as T

    keep = T.select_plan
    if route == "extract_min":
        T.select_plan = lambda nq, w, t, sms: T.SelectPlan("extract_min", 1, w)
    try:
        yield
    finally:
        T.select_plan = keep


@contextlib.contextmanager
def variants_route(route: str):
    """groupmin_width and groupmin_two_level on one of their routes: "mma"
    (epilogues of the bf16 tensor-core sweep, every caller's) or
    "cuda_core" (the row_dot kernels they replaced, which no script path
    takes); this sets ``groupmin_variants.ROUTE`` for the duration."""
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV

    keep = GV.ROUTE
    GV.ROUTE = route
    try:
        yield
    finally:
        GV.ROUTE = keep


#: the extract-min kernel's launches in each main-path run (counts set to 0
#: just before the run, read just after; note_extract_min): the kernels
#: line prints them and their sum
MAIN_PATH_EXTRACT_MIN: dict = {}


def note_extract_min(run: str) -> None:
    """Record the extract-min kernel's launches in the main-path run just
    made; any fails the script, since no search path takes that route."""
    from image_search_engine_tpu_torch.ops import topk as T

    MAIN_PATH_EXTRACT_MIN[run] = T.select_topt.extract_min_launches
    if MAIN_PATH_EXTRACT_MIN[run]:
        raise AssertionError(f"{run}: {MAIN_PATH_EXTRACT_MIN[run]} extract-min select launches")


def assert_same_select(name, mins, t) -> None:
    """select_topt equal to select_topt_ref bit for bit: values (-0.0 kept)
    and ids."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    vals, ids = T.select_topt(mins, t)
    rv, rids = T.select_topt_ref(mins, t)
    if not (torch.equal(vals.view(torch.int32), rv.view(torch.int32))
            and torch.equal(ids, rids)):
        bad = int((ids != rids).sum()) + int((vals.view(torch.int32) != rv.view(torch.int32))
                                             .sum())
        raise AssertionError(f"{name}: select differs from its plain version ({bad} entries)")


def time_select(name, mins, t, flush, extract_min_reps: int = TIMING_REPS) -> dict:
    """select_topt (the radix select) against its plain version bit for
    bit, then timed beside its plain version, torch.topk on the same mins
    (the library call) and the extract-min kernel (the route the radix
    select replaced, forced; also bit-equal, and timed over
    ``extract_min_reps`` runs, its t passes taking ~45 ms at t = 4096, W =
    65,536 on an H100 80GB HBM3 at 700 W); bound: the mins read once and
    the output written once."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    nq, w = mins.shape
    assert_same_select(name, mins, t)
    plan = T.select_plan(nq, w, t, torch.cuda.get_device_properties(0).multi_processor_count)
    b = bound(nq * w * 4 + nq * t * 8, 0, F32_FLOPS)
    topk = lambda: torch.topk(mins, t, dim=1, largest=False)  # noqa: E731
    res = {"route": plan.route, "split": plan.split, "sort": plan.sort, "max_abs_err": 0.0,
           "ms": median_ms(lambda: T.select_topt(mins, t), flush),
           "device_ms": graph_ms(lambda: T.select_topt(mins, t), flush),
           "plain_ms": median_ms(lambda: T.select_topt_ref(mins, t), flush),
           "library_ms": median_ms(topk, flush), "library_device_ms": graph_ms(topk, flush),
           "bound_ms": b[0], "bound_by": b[1], "shape": f"Q={nq} W={w} t={t}"}
    with select_route("extract_min"):
        assert_same_select(f"{name} (extract-min route)", mins, t)
        res["extract_min_ms"] = median_ms(lambda: T.select_topt(mins, t), flush,
                                          extract_min_reps)
        res["extract_min_device_ms"] = graph_ms(lambda: T.select_topt(mins, t), flush,
                                                extract_min_reps)
    log(f"  select_topt {name} Q={nq} W={w} t={t}: = plain bit for bit; {plan.route} "
        f"(split {plan.split}, {plan.sort} sort) {res['ms']:.4f} ms (device "
        f"{res['device_ms']:.4f}), extract-min {res['extract_min_ms']:.4f} ms (device "
        f"{res['extract_min_device_ms']:.4f}), torch.topk {res['library_ms']:.4f} ms (device "
        f"{res['library_device_ms']:.4f}), plain {res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.6f} ms by {res['bound_by']}")
    return res


SELECT_SWEEP_W = (1, 31, 32, 33, 1000, 5088, 7813, 65536)
SELECT_SWEEP_T = (1, 12, 24, 52, 160, 257, 300, 1000, 4096)  # and W - 1
SELECT_SWEEP_Q = (1, 2, 64, 4096)
# but for Q = 4096 at W = 65,536, t = W - 1: the plain version's sort and
# outputs (2 GB a row kind) and the radix sort's 4 GB of scratch
SELECT_SWEEP_MAX_WORK = 2 ** 40
# the select beyond t = 256 timed (the bitonic sort up to 4096), Q = 1 and 64
SELECT_BIG_T = (257, 300, 1000, 4096)


def select_rows(kind: str, nq: int, w: int, gen):
    """(nq, w) f32 rows on the card: "random" N(0, 1); "ties" four levels;
    "zeros" -0.0 and +0.0 mixed with a few N(0, 1) values; "inf" N(0, 1)
    with 80% +inf (IVF pad slots) and a first row all +inf; "hidden" N(0, 1)
    with every 8th entry 100 larger (the radix select's sampled threshold
    then lets more than its scratch through, and it selects over the whole
    row)."""
    import torch

    v = torch.randn(nq, w, device="cuda", generator=gen)
    if kind == "hidden":  # every 8th entry large: the sampled threshold lets too many through
        v[:, ::8] += 100.0
        return v
    if kind == "ties":
        return torch.randint(-2, 2, (nq, w), device="cuda", generator=gen).float()
    u = torch.rand(nq, w, device="cuda", generator=gen)
    if kind == "zeros":
        z = torch.where(u < 0.5, torch.tensor(-0.0, device="cuda"),
                        torch.tensor(0.0, device="cuda"))
        return torch.where(torch.rand(nq, w, device="cuda", generator=gen) < 0.1, v, z)
    if kind == "inf":
        v[u < 0.8] = float("inf")
        v[0] = float("inf")
    return v.contiguous()


def select_sweep(gen, flush) -> dict:
    """select_topt against select_topt_ref bit for bit (values with their
    sign of zero, and ids) at every W in SELECT_SWEEP_W, t in SELECT_SWEEP_T
    and W - 1 (t <= W), Q in SELECT_SWEEP_Q (Q W t <= SELECT_SWEEP_MAX_WORK),
    on each kind of select_rows: every shape on the radix select (split and
    whole rows, sampled or not; its sort by counting, by the bitonic network
    and by the global radix sort), none on the extract-min kernel, each
    counted; the extract-min kernel, forced, bit-equal too at W = 7813 up to
    t = 4096 (Q = 1 and 64). Then timed: the radix select at W = 7813, t =
    24 (Q = 1, a split row; Q = 4096, whole rows), and at each t of
    SELECT_BIG_T, W = 7813 and 65,536, Q = 1 and 64, beside torch.topk and
    the extract-min kernel."""
    from image_search_engine_tpu_torch.ops import topk as T

    T.reset_launch_counts()
    shapes = 0
    for w in SELECT_SWEEP_W:
        for t in sorted({*SELECT_SWEEP_T, w - 1}):
            if not 0 < t <= w:
                continue
            for nq in SELECT_SWEEP_Q:
                if w * t * nq > SELECT_SWEEP_MAX_WORK:
                    continue
                for kind in ("random", "ties", "zeros", "inf", "hidden"):
                    assert_same_select(f"select sweep {kind} Q={nq} W={w} t={t}",
                                       select_rows(kind, nq, w, gen), t)
                    shapes += 1
    launches = {"radix": T.select_topt.radix_launches,
                "extract_min": T.select_topt.extract_min_launches}
    if launches != {"radix": shapes, "extract_min": 0}:
        raise AssertionError(f"select sweep: {shapes} shapes, launches by route {launches}")
    compared = 0
    with select_route("extract_min"):
        for t in SELECT_SWEEP_T:
            for nq in (1, 64):
                for kind in ("random", "ties", "zeros", "inf", "hidden"):
                    assert_same_select(f"extract-min kernel {kind} Q={nq} W=7813 t={t}",
                                       select_rows(kind, nq, 7813, gen), t)
                    compared += 1
    log(f"  select sweep: {shapes} shapes (W {SELECT_SWEEP_W}, t {SELECT_SWEEP_T} and W - 1, Q "
        f"{SELECT_SWEEP_Q}, Q W t <= 2^40; random, tie-heavy, +-0.0, +inf rows and rows whose "
        f"small entries avoid the sampled positions) = plain bit for bit; launches by route "
        f"{launches}; the extract-min kernel (forced) = plain bit for bit on {compared} shapes "
        f"(W = 7813, t up to 4096)")
    routes = {f"radix_Q{nq}": time_select("radix route", select_rows("random", nq, 7813, gen),
                                          24, flush) for nq in (1, 4096)}
    big_t = {f"W{w}_t{t}_Q{nq}": time_select(
        "beyond t = 256", select_rows("random", nq, w, gen), t, flush,
        extract_min_reps=TIMING_REPS if t * w <= 300 * 7813 else 5)
        for w in (7813, 65536) for t in SELECT_BIG_T for nq in (1, 64)}
    return {"shapes": shapes, "launches": launches, "extract_min_compared": compared,
            "routes": routes, "big_t": big_t}


def check_kernels(name, qf, store, knorms, tol):
    """Each kernel against its plain version on the same inputs; the select
    gets the same mins in both versions and must match bit for bit; every
    group min the min of its rescored rows bit for bit; the certificate of
    ``topk_twophase``'s margin true for every query (so no escalation).
    Returns ({kernel: max_abs_err}, mins, candidate ids, t)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops.distances import stable_smallest

    errs = {}
    mins = T.groupmin(qf, store, knorms)
    errs["groupmin"] = max_abs_err(mins, T.groupmin_ref(qf, store, knorms))
    t = min(K + 4, mins.shape[1])
    vals, ids = T.select_topt(mins, t)
    rv, rids = T.select_topt_ref(mins, t)
    if not (torch.equal(vals.view(torch.int32), rv.view(torch.int32))
            and torch.equal(ids, rids)):
        raise AssertionError(f"{name}: select differs from its plain version")
    errs["select_topt"] = 0.0
    scores = T.rescore(qf, store, knorms, ids)
    errs["rescore"] = max_abs_err(scores, T.rescore_ref(qf, store, knorms, ids))
    # one scoring routine in both kernels: a group's min is its rows' min
    if not torch.equal(scores.view(qf.shape[0], t, -1).amin(2), torch.gather(mins, 1, ids.long())):
        raise AssertionError(f"{name}: phase-1 group mins differ from phase-2 scores")
    if t < mins.shape[1]:  # at t = ngroups topk_twophase skips the select and the certificate
        kth = stable_smallest(scores, min(K, scores.shape[1]))[0][:, -1]
        if not bool((kth <= vals[:, -1]).all()):
            raise AssertionError(f"{name}: certificate false for {int((kth > vals[:, -1]).sum())} "
                                 "queries")
    for k in ("groupmin", "rescore"):
        if errs[k] > tol:
            raise AssertionError(f"{name}: {k} error {errs[k]} > tolerance {tol}")
    return errs, mins, ids, t


def kernel_bounds(nq, n, d, isz, ng, t, rows, on_tensor_cores):
    """bound() of groupmin and rescore: the store (or the
    ``rows`` distinct candidate rows), norms, queries and outputs once;
    2 Q N d operations (rescore: 2 Q t 128 d) at the f32 CUDA-core rate,
    three times that at the tf32 rate for f32 on tensor cores (the 3xTF32
    split), once at the bf16 rate for bf16."""
    from image_search_engine_tpu_torch.ops import topk as T

    mult, peak = (1, BF16_FLOPS) if isz == 2 else (3, TF32_FLOPS) if on_tensor_cores else \
        (1, F32_FLOPS)
    return {
        "groupmin": bound(n * d * isz + n * 4 + nq * d * isz + nq * ng * 4,
                          mult * 2 * nq * n * d, peak),
        "rescore": bound(rows * (d * isz + 4) + nq * d * isz + nq * t * (4 + T.GROUP * 4),
                         mult * 2 * nq * t * T.GROUP * d, peak),
    }


def check_shape(name, x, nq, metric, dtype, gen, flush, *, pad_rows=None, q_scale=1.0,
                routes=()):
    """One timed phase-1 shape: the search and the kernels checked, then
    each kernel and its plain version timed. An f32 batch that the wrappers
    put on tensor cores is also checked and timed on the CUDA-core route
    ("cuda_cores": groupmin, rescore, the search). ``routes``: f32 batch
    sizes at which both groupmin routes run on new queries, each within
    score_tol of the plain version, and are timed ("routes" {Q: {route:
    ms}}: where ``F32_CUDA_CORE_MAX_Q`` should lie). Returns {kernel:
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM, local_topk_with_norms

    q = torch.randn(nq, x.shape[1], device="cuda", generator=gen) * q_scale
    index = FlatIndex(metric, dtype=dtype, device="cuda").add(x)
    del x
    store, norms = index.store.vectors, index.store.norms
    if pad_rows is not None:  # poison rows inside the store (zero vectors at the origin)
        store[pad_rows] = 0
        norms[pad_rows] = PAD_NORM
    qs, qf, knorms, tol = check_search(name, index, q)
    if pad_rows is not None and np.isin(index.search(q, K)[1], pad_rows.cpu().numpy()).any():
        raise AssertionError(f"{name}: a PAD_NORM row was returned")
    errs, mins, ids, t = check_kernels(name, qf, store, knorms, tol)

    nq, d = qf.shape
    n, isz, ng = store.shape[0], store.element_size(), mins.shape[1]
    rows = torch.unique(ids).numel() * T.GROUP  # distinct candidate rows this run reads
    f32_mma = isz == 4 and f32_route(store, nq) == "mma"
    bounds = kernel_bounds(nq, n, d, isz, ng, t, rows, isz == 2 or f32_mma)
    res = {}
    for kname, fn, ref in (
        ("groupmin", lambda: T.groupmin(qf, store, knorms),
         lambda: T.groupmin_ref(qf, store, knorms)),
        ("rescore", lambda: T.rescore(qf, store, knorms, ids),
         lambda: T.rescore_ref(qf, store, knorms, ids)),
    ):
        res[kname] = {"max_abs_err": errs[kname], "ms": median_ms(fn, flush),
                      "plain_ms": median_ms(ref, flush), "library_ms": None,
                      "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    # the select beside torch.topk and the extract-min kernel it replaced
    res["select_topt"] = time_select(name, mins, t, flush)
    extra = ""
    # the sweep's yardsticks: the product alone (f32: cuBLAS with TF32 off, as
    # phase 0 set it), and for bf16 the row_dot sweep it replaced
    res["groupmin"]["product_alone_ms"] = median_ms(lambda: torch.matmul(qf, store.T), flush)
    extra += f"; {dtype} product alone {res['groupmin']['product_alone_ms']:.4f} ms"
    if isz == 2:
        with variants_route("cuda_core"):
            res["groupmin"]["row_dot_sweep_ms"] = median_ms(
                lambda: GV.groupmin_width(qf, store, knorms, T.GROUP), flush, reps=3)
        extra += f", row_dot sweep {res['groupmin']['row_dot_sweep_ms']:.4f} ms"
    smetric = "l2" if metric == "l2" else "ip"
    search_ms = median_ms(lambda: T.topk_twophase(qs, store, K, smetric, x_norms=norms), flush)
    res["search_ms"] = search_ms
    if f32_mma:  # the same batch on the CUDA-core route
        with f32_kernel("cuda"):
            cerrs, _, cids, _ = check_kernels(f"{name} (CUDA cores)", qf, store, knorms, tol)
            cb = kernel_bounds(nq, n, d, isz, ng, t, rows, False)
            cc = {k: {"max_abs_err": cerrs[k], "bound_ms": cb[k][0], "bound_by": cb[k][1]}
                  for k in ("groupmin", "rescore")}
            cc["groupmin"]["ms"] = median_ms(lambda: T.groupmin(qf, store, knorms), flush, reps=5)
            cc["rescore"]["ms"] = median_ms(lambda: T.rescore(qf, store, knorms, cids), flush)
            cc["search_ms"] = median_ms(
                lambda: T.topk_twophase(qs, store, K, smetric, x_norms=norms), flush, reps=5)
        res["cuda_cores"] = cc
        extra += (f"; on the CUDA-core route groupmin {cc['groupmin']['ms']:.4f} ms, rescore "
                  f"{cc['rescore']['ms']:.4f} ms, two-phase search {cc['search_ms']:.4f} ms")
    if routes:
        res["routes"] = {}
        for rq in routes:
            rqf = torch.randn(rq, d, device="cuda", generator=gen).to(store.dtype)
            want = T.groupmin_ref(rqf, store, knorms)
            rtol = score_tol(rqf, norms)
            res["routes"][rq] = {}
            for route in ("cuda", "mma"):
                with f32_kernel(route):
                    err = max_abs_err(T.groupmin(rqf, store, knorms), want)
                    if err > rtol:
                        raise AssertionError(f"{name} Q={rq}: groupmin ({route}) error {err} > "
                                             f"tolerance {rtol}")
                    res["routes"][rq][route] = median_ms(
                        lambda: T.groupmin(rqf, store, knorms), flush)
        extra += "; groupmin by route (CUDA cores / tensor cores): " + ", ".join(
            f"Q={rq} {v['cuda']:.4f} / {v['mma']:.4f} ms" for rq, v in res["routes"].items())
    scan_ms = median_ms(lambda: local_topk_with_norms(qs, store, norms, K, smetric), flush)
    log(f"  {name}: tol {tol:.3g}; " + "; ".join(
        f"{k} err {res[k]['max_abs_err']:.3g} {res[k]['ms']:.4f} ms (plain "
        f"{res[k]['plain_ms']:.4f} ms, bound {res[k]['bound_ms']:.4f} ms by {res[k]['bound_by']})"
        for k in ("groupmin", "select_topt", "rescore"))
        + f"; two-phase search {search_ms:.4f} ms, plain full scan {scan_ms:.4f} ms" + extra)
    return res


def edge_sweep(gen) -> float:
    """Small shapes at the kernels' edges, untimed: 1, 2, 4 and 8-query
    tiles (full and partial), rows that are not 16-byte multiples (scalar
    loads), a one-group store (no select), ragged last groups; l2, ip and
    cosine; f32 and bf16. Returns the largest kernel error seen."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex

    worst, cases = 0.0, 0
    for dtype in ("f32", "bf16"):
        for metric in ("l2", "ip", "cosine"):
            for n, d, nq in ((100, 16, 1), (1000, 130, 3), (3000, 256, 2),
                             (5003, 2049, 9), (20_000, 64, 17)):
                name = f"edge N={n} d={d} Q={nq} {dtype} {metric}"
                x = torch.randn(n, d, device="cuda", generator=gen)
                q = torch.randn(nq, d, device="cuda", generator=gen)
                index = FlatIndex(metric, dtype=dtype, device="cuda").add(x)
                _, qf, knorms, tol = check_search(name, index, q)
                errs, *_ = check_kernels(name, qf, index.store.vectors, knorms, tol)
                worst = max(worst, *errs.values())
                cases += 1
    log(f"  edge sweep: {cases} shapes ok, largest kernel error {worst:.3g}")
    return worst


def edge_sweep_mma(gen, dtype, nqs, ds) -> float:
    """The tensor-core kernels of ``dtype`` (torch.bfloat16, or torch.float32
    held on the tensor-core route) at their tile edges, untimed: N in {1,
    127, 128, 129, 5000} x Q in ``nqs`` x d in ``ds`` (bf16 d = 130: 4-byte
    copies; f32 d = 16, 132, 2052: a partial last 32-column stage; f32 d =
    130, 2049, rows of no whole 16-byte units: the CUDA-core route in both
    phases, checked here; Q = 17, 33, 129: partial query tiles), l2 and ip
    in turn (ip: the query halved, zero norms, 10% of the rows poisoned
    with PAD_NORM). check_kernels: each within score_tol of its plain
    version, the group mins the rescored rows' mins bit for bit, the
    certificate true. Returns the largest kernel error on tensor cores."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM, ip_penalty

    worst, cases, on_tc = 0.0, 0, 0
    name = str(dtype).split(".")[-1]
    route = f32_kernel("mma") if dtype == torch.float32 else contextlib.nullcontext()
    with route:
        for n in (1, 127, 128, 129, 5000):
            for nq in nqs:
                for d in ds:
                    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
                    q = torch.randn(nq, d, device="cuda", generator=gen).to(dtype)
                    norms = (x.float() ** 2).sum(1)
                    if cases % 2:
                        norms[torch.rand(n, device="cuda", generator=gen) < 0.1] = PAD_NORM
                        qf, knorms = (q * 0.5).contiguous(), ip_penalty(norms)
                    else:
                        qf, knorms = q, norms
                    tol = score_tol(qf, norms) if bool((norms < 1e29).any()) else 0.0
                    T.reset_launch_counts()
                    errs, *_ = check_kernels(f"{name} edge N={n} Q={nq} d={d}", qf, x, knorms,
                                             tol)
                    tc = (T.groupmin.tensor_core_launches, T.rescore.tensor_core_launches)
                    want = dtype == torch.bfloat16 or d % 4 == 0
                    if tc != (int(want), int(want)):
                        raise AssertionError(f"{name} edge N={n} Q={nq} d={d}: tensor-core "
                                             f"launches {tc}, want {int(want)} of each")
                    if want:
                        worst = max(worst, errs["groupmin"], errs["rescore"])
                        on_tc += 1
                    cases += 1
    rest = f" ({cases - on_tc} on CUDA cores in both phases)" if on_tc < cases else ""
    log(f"  {name} tensor-core edge sweep: {cases} shapes (l2, ip with PAD_NORM rows){rest}, "
        f"largest tensor-core error {worst:.3g}, group mins = rescored rows' mins bit for bit, "
        "certificates true")
    return worst


def one_sign_rows_f32(gen) -> float:
    """The f32 tensor-core kernels over rows and queries of one sign (|N(0,
    1)|, as post-ReLU embeddings are), where every product of a dot adds in
    one direction: Q = 64 over 100,000 x 2048 l2, random queries and
    queries next to store rows, check_kernels as in the edge sweep. Returns
    the largest error over its tolerance."""
    import torch

    rows = torch.randn(100_000, 2048, device="cuda", generator=gen).abs()
    norms = (rows * rows).sum(1)
    worst = 0.0
    with f32_kernel("mma"):
        for what, q in (("random", torch.randn(64, 2048, device="cuda", generator=gen).abs()),
                        ("near store rows", rows[:64] + 0.01 * torch.randn(
                            64, 2048, device="cuda", generator=gen))):
            tol = score_tol(q, norms)
            errs, *_ = check_kernels(f"f32 one-sign rows, {what} queries", q.contiguous(), rows,
                                     norms, tol)
            worst = max(worst, errs["groupmin"] / tol, errs["rescore"] / tol)
            log(f"  f32 one-sign rows Q=64 N=100,000 d=2048, {what} queries: groupmin err "
                f"{errs['groupmin']:.4g}, rescore err {errs['rescore']:.4g} (tol {tol:.4g})")
    return worst


def phase1() -> dict:
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    log("phase 1: kernels against their plain versions")
    shapes = {}
    x = torch.randn(1_000_000, 2048, device="cuda", generator=gen)
    # f32 beside cuBLAS's f32 product alone: Q = 1 on CUDA cores, with both
    # sweeps at the batch sizes where F32_CUDA_CORE_MAX_Q lies; Q = 64 and
    # 256 (128-query tiles) on tensor cores (3xTF32), and on the CUDA-core
    # route
    for nq, routes in ((1, (1, 2, 4, 8, 16)), (64, ()), (256, ())):
        shapes[f"Q{nq}_N1M_d2048_f32_l2"] = check_shape(f"Q={nq} N=1,000,000 d=2048 f32 l2", x,
                                                        nq, "l2", "f32", gen, flush,
                                                        routes=routes)
    for nq in (1, 64):  # the bf16 tensor-core kernels at the corpus scale
        shapes[f"Q{nq}_N1M_d2048_bf16_l2"] = check_shape(
            f"Q={nq} N=1,000,000 d=2048 bf16 l2", x, nq, "l2", "bf16", gen, flush)
    del x
    torch.cuda.empty_cache()
    x = torch.randn(200_003, 2048, device="cuda", generator=gen)
    shapes["Q64_N200003_d2048_bf16_ip"] = check_shape(
        "Q=64 N=200,003 d=2048 bf16 ip", x, 64, "ip", "bf16", gen, flush)
    del x
    base = torch.randn(25_000, 2048, device="cuda", generator=gen)
    x = base[torch.randint(0, 25_000, (100_000,), device="cuda", generator=gen)]
    shapes["ties_Q8_N100000_d2048_f32_l2"] = check_shape(
        "tie-heavy Q=8 N=100,000 d=2048 f32 l2 (rows duplicated ~4x)", x, 8, "l2", "f32",
        gen, flush)
    del x, base
    x = torch.randn(100_000, 2048, device="cuda", generator=gen) * 10
    pads = torch.randperm(100_000, device="cuda", generator=gen)[:10_000]
    shapes["pad_Q4_N100000_d2048_f32_l2"] = check_shape(
        "PAD_NORM rows Q=4 N=100,000 d=2048 f32 l2 (10% poisoned, queries at the origin)",
        x, 4, "l2", "f32", gen, flush, pad_rows=pads, q_scale=1e-3)
    del x
    torch.cuda.empty_cache()
    edge_sweep(gen)
    mma_edge = {"bf16": edge_sweep_mma(gen, torch.bfloat16, (1, 7, 15, 16, 17, 33, 129),
                                       (16, 128, 130, 2048)),
                "f32": edge_sweep_mma(gen, torch.float32,
                                      (T.F32_CUDA_CORE_MAX_Q + 1, 15, 16, 17, 33, 129),
                                      (16, 128, 130, 132, 2049, 2052)),
                "f32_one_sign_err_over_tol": one_sign_rows_f32(gen)}
    return shapes, mma_edge, select_sweep(gen, flush)


# ---------------------------------------------------------------------------
# Phase 2: the main path through the entry points
# ---------------------------------------------------------------------------


def write_corpus(root: Path, n: int, size: int = 224) -> list:
    """n distinct smooth PNGs: seeded 8x8 random colour fields, upsampled."""
    from PIL import Image

    root.mkdir(parents=True)
    lows = (np.random.default_rng(SEED).random((n, 8, 8, 3)) * 255).astype(np.uint8)

    def write(i: int) -> Path:
        p = root / f"img_{i:05d}.png"
        Image.fromarray(lows[i]).resize((size, size), Image.BILINEAR).save(p)
        return p

    with cf.ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, range(n)))


def post_image(url: str, data: bytes, filename: str = "q.png"):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n"
            ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_embedder() -> None:
    """The default bf16 ResNet-50 on the card against the same weights in
    f32 on the CPU: finite (B, 2048) rows within the bf16 tolerance."""
    import torch

    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    imgs = (np.random.default_rng(SEED + 1).random((2, 224, 224, 3)) * 255).astype(np.uint8)
    got = CNNEmbedder("resnet50", device="cuda").embed_batch(imgs)
    ref = CNNEmbedder("resnet50", dtype=torch.float32, device="cpu").embed_batch(imgs)
    rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
    log(f"  embedder: bf16 on the card vs f32 on the CPU, per-row relative L2 error "
        f"{rel.max():.4g} (tolerance 3e-2)")
    if got.shape != (2, 2048) or not np.isfinite(got).all() or rel.max() > 3e-2:
        raise AssertionError(f"embedder check failed: shape {got.shape}, rel err {rel}")


def index_corpus(workdir: Path, name: str, *flags: str) -> Path:
    """The port's indexer CLI over the corpus PNGs (ResNet-50 on the card)
    into ``workdir / name``; returns that artifacts directory."""
    from image_search_engine_tpu_torch import indexer as port_indexer

    art = workdir / name
    t0 = time.perf_counter()
    port_indexer.cli_main(["--data-dir", str(workdir / "images"), "--artifacts-dir", str(art),
                           "--method", "dnn", "--dnn-model", "resnet50", *flags,
                           "--device", "cuda"])
    log(f"  indexed ({' '.join(flags)}) in {time.perf_counter() - t0:.1f} s")
    return art


def serve_and_query(art: Path, index_type: str, paths: list, label: str,
                    own_first: bool = True) -> dict:
    """The port's HTTP server on ``art``, 8 corpus images posted one at a
    time: each answers 200 with K finite ascending distances and the
    query's own file first (``own_first``) or among the K; a garbage upload
    answers 400 and /healthz counts the corpus. The kernels' launch counts
    are set to 0 just before the 8 requests and read just after. Returns
    {engine, launches, p50_ms, first, escalations}."""
    from image_search_engine_tpu_torch import engine as port_engine
    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import topk as T

    cfg, device = port_engine.parse_args(["--artifacts-dir", str(art), "--index-type", index_type,
                                          "--port", "0", "--device", "cuda"])
    engine, httpd = port_engine.make_server(cfg, device)  # prewarm builds + runs the kernels
    if engine.index.ntotal != len(paths):
        raise AssertionError(f"{label}: engine loaded {engine.index.ntotal} rows")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        T.reset_launch_counts()
        reset_scan_counts()
        first, lat = 0, []
        for i in np.linspace(0, len(paths) - 1, 8).astype(int):
            t0 = time.perf_counter()
            status, js = post_image(base + "/similar_images", paths[i].read_bytes())
            lat.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"{label} query {i}: HTTP {status} {js}")
            pred = js["prediction"]
            dists, names = [p[0] for p in pred], [p[2] for p in pred]
            if len(pred) != K or str(paths[i]) not in names[:1 if own_first else K]:
                raise AssertionError(f"{label} query {i}: {len(pred)} results, top-1 {names[0]}")
            if not (np.all(np.isfinite(dists)) and dists == sorted(dists)):
                raise AssertionError(f"{label} query {i}: distances not finite ascending: {dists}")
            first += names[0] == str(paths[i])
        counts = {**T.launch_counts(), "select_topt_radix": T.select_topt.radix_launches,
                  "group_order": T.group_order.launches, "probed_scan": IV.probed_scan.launches,
                  "probed_scan_slot": IV.probed_scan.slot_launches,
                  "probed_scan_bucket": IV.probed_scan.bucket_launches}
        note_extract_min(f"{label} serving")
        status, _ = post_image(base + "/similar_images", b"not an image")
        if status != 400:
            raise AssertionError(f"{label} garbage upload answered {status}, want 400")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("corpus") != len(paths):
            raise AssertionError(f"{label} healthz: {health}")
        escalations = engine.stats.snapshot()["certificate_escalations"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return {"engine": engine, "launches": counts, "p50_ms": float(np.median(lat)) * 1e3,
            "first": first, "escalations": escalations}


def phase2(workdir: Path) -> dict:
    log("phase 2: the main path (indexer CLI -> HTTP server)")
    check_embedder()
    t0 = time.perf_counter()
    paths = write_corpus(workdir / "images", 4096)
    log(f"  wrote {len(paths)} PNGs in {time.perf_counter() - t0:.1f} s")
    art = index_corpus(workdir, "artifacts", "--index-type", "l2")
    out = serve_and_query(art, "l2", paths, "flat")
    counts = {k: out["launches"][k] for k in ("groupmin", "select_topt", "rescore")}
    if out["engine"].index.ntotal // 128 <= K + 4:
        raise AssertionError("the index must have more groups than t so the select runs")
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel did not launch while serving: {counts}")
    if out["launches"]["select_topt_radix"] != counts["select_topt"]:
        raise AssertionError(f"serving's select took the extract-min route: {out['launches']}")
    log(f"  8 queries ok (top-1 = the query's own file); launches while serving {counts}; "
        f"request latency p50 {out['p50_ms']:.2f} ms (client clock, 8 requests); "
        f"certificate escalations {out['escalations']}")
    return {"launches": counts, "p50_ms": out["p50_ms"], "escalations": out["escalations"],
            "paths": paths, "art": art, "batch": search_batch(out["engine"].index),
            "select_radix_launches": out["launches"]["select_topt_radix"],
            "select": served_select(out["engine"].index)}


def served_select(index) -> dict:
    """select_topt on the served index's group mins for one of its rows
    (Q = 1, W = 32 groups, t = K + 4, as each request runs it), against its
    plain version bit for bit and timed (time_select)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    store = index.store
    mins = T.groupmin(store.values()[:1].to(store.vectors.dtype).contiguous(), store.vectors,
                      store.norms)
    return time_select("served index (4,096 rows, f32)", mins, K + 4, flush)


def search_batch(index) -> dict:
    """A batch caller's path over the served f32 index: 64 of its stored
    embeddings through FlatIndex.search in one call, beyond
    F32_CUDA_CORE_MAX_Q, so on the tensor-core route (launch counts set to
    0 just before, read just after); each stored row its own nearest, and
    the search against the plain full scan (check_search)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    rows = np.arange(0, index.ntotal, index.ntotal // 64)[:64]
    q = index.store.values()[torch.as_tensor(rows, device=index.store.vectors.device)]
    T.reset_launch_counts()
    _, ids = index.search(q, K)
    launches = {"groupmin": T.groupmin.tensor_core_launches,
                "rescore": T.rescore.tensor_core_launches, "select_topt": T.select_topt.launches}
    note_extract_min("flat batch Q=64")
    if not all(launches.values()):
        raise AssertionError(f"f32 batch Q=64: a tensor-core kernel did not launch: {launches}")
    if not np.array_equal(ids[:, 0], rows):
        raise AssertionError("f32 batch Q=64: a stored row is not its own nearest")
    check_search("f32 batch Q=64 (served index)", index, q)
    log(f"  batch of 64 stored embeddings through FlatIndex.search: each its own nearest, = the "
        f"plain full scan, certificates true; tensor-core launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 3: IVF-PQ
# ---------------------------------------------------------------------------


def latent_rows(n: int, centres, proj, gen, chunk: int = 1 << 17):
    """n rows on the card: a random one of the latent ``centres`` plus unit
    latent noise, projected by ``proj`` (latent x d), plus 0.1 isotropic
    noise; built in chunks. Isotropic 2048-d blobs put every member of a
    blob at nearly the same distance, so recall on them measures noise; a
    low-dimensional latent gives neighbours that can be ranked."""
    import torch

    out = torch.empty(n, proj.shape[1], device="cuda")
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        lab = torch.randint(0, centres.shape[0], (e - s,), device="cuda", generator=gen)
        z = centres[lab] + torch.randn(e - s, centres.shape[1], device="cuda", generator=gen)
        out[s:e] = z @ proj + 0.1 * torch.randn(e - s, proj.shape[1], device="cuda",
                                                generator=gen)
    return out


def check_assign(name: str, x, c):
    """``assign`` against ``assign_ref`` on the same tensors. Both sum d f32
    products in different orders, so distances may differ by 4 sqrt(d)
    ulps of the magnitudes summed, (|x| + |c|)^2, and codes may differ only
    where the plain version's two best distances lie within that.
    Returns (max_abs_err, tolerance, differing codes)."""
    import torch

    from image_search_engine_tpu_torch.ops import kmeans as KM

    codes, dists = KM.assign(x, c)
    rcodes, rdists = KM.assign_ref(x, c)
    xm, cm = x.norm(dim=-1).max().item(), c.norm(dim=-1).max().item()
    tol = 4 * math.sqrt(x.shape[-1]) * EPS32 * (xm + cm) ** 2
    err = max_abs_err(dists, rdists)
    if err > tol:
        raise AssertionError(f"{name} assign: distance error {err} > tolerance {tol}")
    bad = (codes != rcodes).view(-1, x.shape[-2])
    xb, cb = (x, c) if x.dim() == 3 else (x[None], c[None])
    for b in range(xb.shape[0]):
        rows = bad[b].nonzero()[:, 0]
        if rows.numel():
            part = (cb[b] * cb[b]).sum(1)[None] - 2.0 * (xb[b, rows] @ cb[b].T)
            top2 = part.topk(2, dim=1, largest=False).values
            gap = (top2[:, 1] - top2[:, 0]).max().item()
            if gap > 2 * tol:
                raise AssertionError(f"{name} assign: codes differ where the best two "
                                     f"distances are {gap} apart (tolerance {tol})")
    return err, tol, int(bad.sum())


def plain_probed_topk(q, bc, table, norms, lists, k, nprobe):
    """ivf_probed_topk through each kernel's plain version (same probes)."""
    import torch

    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import topk as T

    probe = IV.rank_buckets(q, bc, nprobe)
    scores = IV.probed_scan_ref(q.to(table.dtype), table, norms, probe.to(torch.int32))
    vals, pos = T.select_topt_ref(scores, k)
    ids = lists[probe].reshape(q.shape[0], -1).gather(1, pos.long())
    return (vals + (q * q).sum(1, keepdim=True)).clamp(min=0.0), ids


@contextlib.contextmanager
def scan_route(route: str):
    """probed_scan on one of its routes whatever the batch: "slot" or
    "bucket", the kernel and its tile planned for that route
    (``probed_scan_plan(..., route=route)``); this swaps
    ``probed_scan_plan`` for the duration."""
    from image_search_engine_tpu_torch.ops import ivf as IV

    keep = IV.probed_scan_plan
    IV.probed_scan_plan = lambda *a: keep(*a, route=route)
    try:
        yield
    finally:
        IV.probed_scan_plan = keep


def check_probed_scan(name, qf, table, norms, probe, flush, reps: int = TIMING_REPS) -> dict:
    """probed_scan on both routes: bit-equal to each other (the same
    row_dot arithmetic), within score_tol of probed_scan_ref, each timed
    (CUDA events, and a CUDA graph's replay for the device's time alone)
    beside the plain version; bound: the distinct probed buckets' rows and
    norms read once, the queries and probe ids read once, the scores
    written once (or 2 cap d flops a slot at the f32 rate, if larger)."""
    import torch

    from image_search_engine_tpu_torch.ops import ivf as IV

    nq, d = qf.shape
    nb, cap, _ = table.shape
    nprobe = probe.shape[1]
    isz = table.element_size()
    plan = IV.probed_scan_plan(nq, nprobe, nb, cap, d, isz)
    tol = score_tol(qf, norms)
    ref = IV.probed_scan_ref(qf, table, norms, probe)
    res = {"route": plan.route, "tol": tol, "shape": f"Q={nq} nprobe={nprobe} cap={cap} d={d} "
           f"{str(table.dtype).replace('torch.', '')} table, {nb} buckets"}
    got = {}
    for route in ("slot", "bucket"):
        with scan_route(route):
            got[route] = IV.probed_scan(qf, table, norms, probe)
            res[f"{route}_ms"] = median_ms(lambda: IV.probed_scan(qf, table, norms, probe), flush,
                                           reps)
            res[f"{route}_device_ms"] = graph_ms(
                lambda: IV.probed_scan(qf, table, norms, probe), flush, reps)
    if not torch.equal(got["slot"].view(torch.int32), got["bucket"].view(torch.int32)):
        raise AssertionError(f"probed_scan {name}: the routes' scores differ")
    res["max_abs_err"] = max_abs_err(got["bucket"], ref)
    if res["max_abs_err"] > tol:
        raise AssertionError(f"probed_scan {name}: error {res['max_abs_err']} > tolerance {tol}")
    res["ms"], res["device_ms"] = res[f"{plan.route}_ms"], res[f"{plan.route}_device_ms"]
    res["device_clean_l2_ms"] = graph_ms(lambda: IV.probed_scan(qf, table, norms, probe),
                                         ReadFlush(flush), reps)
    res["plain_ms"] = median_ms(lambda: IV.probed_scan_ref(qf, table, norms, probe), flush,
                                min(reps, 5))
    ub = torch.unique(probe[(probe >= 0) & (probe < nb)]).numel()  # distinct buckets read
    res["bound_ms"], res["bound_by"] = bound(
        ub * cap * (d * isz + 4) + nq * d * isz + nq * nprobe * (4 + cap * 4),
        2 * nq * nprobe * cap * d, F32_FLOPS)
    res["buckets"], res["slots"] = ub, nq * nprobe
    log(f"  probed_scan {name} ({res['shape']}, {ub} distinct buckets of {nq * nprobe} slots): "
        f"routes bit-equal, err {res['max_abs_err']:.3g} (tol {tol:.3g}); slot route "
        f"{res['slot_ms']:.4f} ms (device {res['slot_device_ms']:.4f}), bucket route "
        f"{res['bucket_ms']:.4f} ms (device {res['bucket_device_ms']:.4f}), the plan's: "
        f"{plan.route} (device {res['device_clean_l2_ms']:.4f} ms after a flush that leaves no "
        f"dirty lines); plain {res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}")
    return res


def probed_topk_breakdown(q, bc, table, norms, lists, k, nprobe, flush) -> dict:
    """ivf_probed_topk at len(q) queries split into its steps as it runs
    them, CUDA-event medians (L2 flushed before each): the whole call, the
    device's time of its CUDA graph, then rank_buckets, the query and probe
    casts, the probed scan, the lists gather, the select and the finish
    (ids, flags, distances); the rest is what the steps' separate timings
    miss."""
    import torch

    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import topk as T

    nq, cap = q.shape[0], table.shape[1]
    probe = IV.rank_buckets(q, bc, nprobe)
    qf, probe32 = q.to(table.dtype).contiguous(), probe.to(torch.int32).contiguous()
    scores = IV.probed_scan(qf, table, norms, probe32)
    cand = lists[probe].reshape(nq, nprobe * cap)
    vals, pos = T.select_topt(scores, k)

    def finish():
        ids = torch.gather(cand, 1, pos.long())
        ok = torch.isfinite(vals) & (ids >= 0)
        qnorm = (q.float() * q.float()).sum(1, keepdim=True)
        return torch.clamp(vals + qnorm, min=0.0), ids, ok

    call = lambda: IV.ivf_probed_topk(q, bc, table, norms, lists, k, nprobe)  # noqa: E731
    res = {"topk_ms": median_ms(call, flush), "topk_device_ms": graph_ms(call, flush),
           "rank_buckets_ms": median_ms(lambda: IV.rank_buckets(q, bc, nprobe), flush),
           "casts_ms": median_ms(lambda: (q.to(table.dtype).contiguous(),
                                          probe.to(torch.int32).contiguous()), flush),
           "scan_ms": median_ms(lambda: IV.probed_scan(qf, table, norms, probe32), flush),
           "gather_ms": median_ms(lambda: lists[probe].reshape(nq, nprobe * cap), flush),
           "select_ms": median_ms(lambda: T.select_topt(scores, k), flush),
           "finish_ms": median_ms(finish, flush)}
    res["other_ms"] = res["topk_ms"] - sum(res[f"{s}_ms"] for s in (
        "rank_buckets", "casts", "scan", "gather", "select", "finish"))
    log(f"  ivf_probed_topk Q={nq} k={k} split: {res['topk_ms']:.4f} ms (device "
        f"{res['topk_device_ms']:.4f}) = rank_buckets {res['rank_buckets_ms']:.4f} + casts "
        f"{res['casts_ms']:.4f} + probed_scan {res['scan_ms']:.4f} + lists gather "
        f"{res['gather_ms']:.4f} + select {res['select_ms']:.4f} + finish "
        f"{res['finish_ms']:.4f} + rest {res['other_ms']:.4f} ms")
    return res


def phase3_scale() -> dict:
    """IVF-PQ over 1M x 2048 clustered rows: build, each kernel against its
    plain version, timings, and the search against ADC and exact search."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.index.ivf import IVFPQIndex
    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import kmeans as KM
    from image_search_engine_tpu_torch.ops import topk as T

    log("phase 3: IVF-PQ at corpus scale")
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    centres = 2.0 * torch.randn(SCALE_CENTRES, SCALE_LATENT, device="cuda", generator=gen)
    proj = torch.randn(SCALE_LATENT, SCALE_D, device="cuda", generator=gen) / SCALE_LATENT ** 0.5
    x = latent_rows(SCALE_N, centres, proj, gen)
    q64 = latent_rows(64, centres, proj, gen)
    torch.cuda.synchronize()
    KM.assign.launches = 0
    t0 = time.perf_counter()
    index = IVFPQIndex("l2", nlist=NLIST, nprobe=NPROBE, m=PQ_M, device="cuda").add(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nb, cap = index.lists.shape
    nprobe = index._effective_nprobe()
    log(f"  built IVFPQIndex(nlist={NLIST}, nprobe={NPROBE}, m={PQ_M}) over {SCALE_N:,} x "
        f"{SCALE_D} f32 ({SCALE_CENTRES} centres in {SCALE_LATENT}-d, projected) in "
        f"{build_s:.1f} s: "
        f"{KM.assign.launches} assign launches, {nb} buckets of cap {cap}, {nprobe} probed "
        f"per query, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # k-means assignment: one coarse call, and one batched PQ-books chunk
    cents = torch.as_tensor(index.centroids, device="cuda")
    err_c, tol_c, bad_c = check_assign("coarse", x, cents)
    cells = KM.assign(x[:65536], cents)[0].long()
    resid = (x[:65536] - cents[cells]).view(65536, PQ_M, SCALE_D // PQ_M).transpose(0, 1)
    books = torch.as_tensor(index.pq_books, device="cuda")
    err_b, tol_b, bad_b = check_assign("PQ books", resid, books)
    assign_ms = median_ms(lambda: KM.assign(x, cents), flush, reps=5)
    assign_plain_ms = median_ms(lambda: KM.assign_ref(x, cents), flush, reps=5)
    product_ms = median_ms(lambda: torch.matmul(x, cents.T), flush, reps=5)  # TF32 off
    books_ms = median_ms(lambda: KM.assign(resid, books), flush)
    books_plain_ms = median_ms(lambda: KM.assign_ref(resid, books), flush)
    # the kernel does its 2 N K d products three times on the tf32 tensor
    # cores; the f32 CUDA cores would need 2 N K d once
    a_bytes = SCALE_N * SCALE_D * 4 + NLIST * (SCALE_D * 4 + 4) + SCALE_N * 8
    a_bound = bound(a_bytes, 3 * 2 * SCALE_N * NLIST * SCALE_D, TF32_FLOPS)
    a_bound_f32 = bound(a_bytes, 2 * SCALE_N * NLIST * SCALE_D, F32_FLOPS)
    log(f"  assign N={SCALE_N:,} K={NLIST} d={SCALE_D}: err {err_c:.3g} (tol {tol_c:.3g}), "
        f"{bad_c} codes differ at near-ties; {assign_ms:.3f} ms (plain {assign_plain_ms:.3f} "
        f"ms, cuBLAS f32 product alone {product_ms:.3f} ms; 3xTF32 bound {a_bound[0]:.3f} ms "
        f"by {a_bound[1]}, f32 CUDA-core bound {a_bound_f32[0]:.3f} ms); PQ books B={PQ_M} "
        f"N=65,536 K=256 dsub={SCALE_D // PQ_M}: err {err_b:.3g} (tol {tol_b:.3g}), {bad_b} "
        f"near-tie codes, {books_ms:.3f} ms (plain {books_plain_ms:.3f} ms)")
    del cells, resid

    # the probed scan on the serving table (bf16 reconstruction, kept
    # resident as the engine keeps it) and on the raw f32 table
    index.recon_cache = True
    t0 = time.perf_counter()
    recon, rnorms = index.recon_table()
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    log(f"  reconstruction table ({recon.numel() * 2 / 1e9:.2f} GB bf16) built in "
        f"{recon_s * 1e3:.1f} ms")
    bc, lists, _, _, _ = index._device_arrays_pq()
    scan = {}
    for nq in (1, 64):
        q = q64[:nq]
        probe = IV.rank_buckets(q, bc, nprobe).to(torch.int32).contiguous()
        qf = q.to(recon.dtype).contiguous()
        res = check_probed_scan(f"IVF-PQ Q={nq}", qf, recon, rnorms, probe, flush)
        d, i, ok = IV.ivf_probed_topk(q, bc, recon, rnorms, lists, K, nprobe)
        rd, ri = plain_probed_topk(q, bc, recon, rnorms, lists, K, nprobe)
        if not bool(ok.all()):
            raise AssertionError(f"probed top-k Q={nq}: invalid slots among the top {K}")
        assert_same_topk(d.cpu().numpy(), i.cpu().numpy(), rd.cpu().numpy(), ri.cpu().numpy(),
                         2 * res["tol"], f"probed top-k Q={nq}")
        res["select"] = time_select("IVF-PQ probed width", IV.probed_scan(qf, recon, rnorms,
                                                                          probe), K, flush)
        res["topk_ms"] = median_ms(lambda: IV.ivf_probed_topk(q, bc, recon, rnorms, lists, K,
                                                               nprobe), flush)
        log(f"  probed top-{K} Q={nq}: {res['topk_ms']:.4f} ms, ids = plain route's")
        scan[nq] = res
    # the batch on the other side of the plan's crossing over these rows:
    # Q = 64 above takes the slot route, Q = 128 the bucket route (queries
    # from a generator of their own, so the rest of the phase is unchanged)
    q128 = latent_rows(128, centres, proj, torch.Generator(device="cuda").manual_seed(SEED + 31))
    scan[128] = check_probed_scan("IVF-PQ Q=128", q128.to(recon.dtype).contiguous(), recon,
                                  rnorms, IV.rank_buckets(q128, bc, nprobe).to(torch.int32)
                                  .contiguous(), flush)
    if (scan[64]["route"], scan[128]["route"]) != ("slot", "bucket"):
        raise AssertionError(f"IVF-PQ: the plan takes {scan[64]['route']} at Q=64, "
                             f"{scan[128]['route']} at Q=128")
    del q128
    scan["breakdown_Q1"] = probed_topk_breakdown(q64[:1], bc, recon, rnorms, lists, K, nprobe,
                                                 flush)
    qf = q64.contiguous()
    probe = IV.rank_buckets(qf, bc, nprobe).to(torch.int32).contiguous()
    err_raw = max_abs_err(IV.probed_scan(qf, index.packed, index.packed_norms, probe),
                          IV.probed_scan_ref(qf, index.packed, index.packed_norms, probe))
    if err_raw > score_tol(qf, index.packed_norms):
        raise AssertionError(f"probed_scan on the f32 table: error {err_raw}")
    scan["max_abs_err"] = max(scan[1]["max_abs_err"], scan[64]["max_abs_err"],
                              scan[128]["max_abs_err"], err_raw)

    # search quality: the probed scan against ADC, and rerank against exact
    _, i_adc = index.search(q64, 10)
    _, i_b = index.search_batched(q64, 10)
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                             for a, b in zip(i_adc, i_b)]))
    flat = FlatIndex("l2", device="cuda").add(x)
    _, i_true = flat.search(q64, 10)
    del flat
    _, i_rr = index.search_batched(q64, 10, rerank=64)
    _, i_rr256 = index.search_batched(q64, 10, rerank=256)
    _, i_raw, _ = IV.ivf_probed_topk(q64, bc, index.packed, index.packed_norms, lists, 10, nprobe)

    def recall(i):
        return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                              for a, b in zip(i, i_true)]))

    rec_adc, rec_rr = recall(i_b), recall(i_rr)
    log(f"  Q=64 k=10: search_batched vs ADC search top-10 overlap {overlap:.4f} (bar 0.9); "
        f"recall@10 vs exact FlatIndex: probing alone (raw f32 table) "
        f"{recall(i_raw.cpu().numpy()):.4f}, ADC {rec_adc:.4f}, rerank=64 {rec_rr:.4f}, "
        f"rerank=256 {recall(i_rr256):.4f}")
    if overlap < 0.9 or rec_rr < rec_adc:
        raise AssertionError(f"IVF-PQ search quality: overlap {overlap}, recall ADC {rec_adc} "
                             f"vs rerank {rec_rr}")
    serve_ms = {nq: median_ms(lambda: index.search_batched(q64[:nq], K, rerank=64), flush)
                for nq in (1, 64)}
    # k and rerank shortlists beyond 256: the select's radix route (its
    # bitonic sort) on a user's path, and no extract-min launch
    k_wide = 300
    T.reset_launch_counts()
    d_wide, i_wide = index.search_batched(q64[:8], k_wide, rerank=0)
    wide = {"radix": T.select_topt.radix_launches,
            "extract_min": T.select_topt.extract_min_launches}
    note_extract_min(f"IVF-PQ k={k_wide}")
    rd, ri = plain_probed_topk(q64[:8], bc, recon, rnorms, lists, k_wide, nprobe)
    assert_same_topk(d_wide, i_wide, rd.cpu().numpy(), ri.cpu().numpy(),
                     2 * score_tol(q64[:8].to(recon.dtype), rnorms), f"IVF-PQ k={k_wide}")
    T.reset_launch_counts()
    _, i_rr1000 = index.search_batched(q64, K, rerank=1000)
    rerank = {"radix": T.select_topt.radix_launches,
              "extract_min": T.select_topt.extract_min_launches}
    note_extract_min("IVF-PQ rerank=1000")
    if not (wide["radix"] and rerank["radix"]) or wide["extract_min"] or rerank["extract_min"]:
        raise AssertionError(f"IVF-PQ beyond t = 256: select launches {wide} (k={k_wide}), "
                             f"{rerank} (rerank=1000)")
    sd, si, _ = IV.ivf_probed_topk(q64, bc, recon, rnorms, lists, 1000, nprobe)
    rd, ri = plain_probed_topk(q64, bc, recon, rnorms, lists, 1000, nprobe)
    assert_same_topk(sd.cpu().numpy(), si.cpu().numpy(), rd.cpu().numpy(), ri.cpu().numpy(),
                     2 * score_tol(q64.to(recon.dtype), rnorms), "IVF-PQ shortlist of 1000")
    rec1000 = recall(i_rr1000[:, :10])
    if rec1000 < rec_rr:
        raise AssertionError(f"IVF-PQ rerank=1000 recall@10 {rec1000} < rerank=64's {rec_rr}")
    log(f"  search_batched(k={k_wide}) over 8 queries: = the plain route's top-{k_wide}; "
        f"search_batched(k={K}, rerank=1000) over 64: its shortlist = the plain route's, "
        f"recall@10 vs exact {rec1000:.4f}; select launches by route {wide} and {rerank}")
    log(f"  search_batched(k={K}, rerank=64) incl. host transfer: Q=1 {serve_ms[1]:.3f} ms, "
        f"Q=64 {serve_ms[64]:.3f} ms")
    del index, recon, rnorms, x
    torch.cuda.empty_cache()
    return {"build_s": build_s, "scan": scan, "nprobe": nprobe, "cap": cap,
            "beyond_256_launches": {"k300": wide, "rerank1000": rerank},
            "assign": {"max_abs_err": max(err_c, err_b), "ms": assign_ms,
                       "plain_ms": assign_plain_ms, "bound": a_bound,
                       "f32_cuda_core_bound_ms": a_bound_f32[0], "product_alone_ms": product_ms,
                       "books_ms": books_ms, "books_plain_ms": books_plain_ms}}


def reset_scan_counts() -> None:
    """probed_scan's launch counts, all and per route, to 0."""
    from image_search_engine_tpu_torch.ops import ivf as IV

    IV.probed_scan.launches = IV.probed_scan.slot_launches = IV.probed_scan.bucket_launches = 0


def batched_ivf_data(d: int = BATCHED_D):
    """benchmarks/ivf_batched_1m.py's corpus and queries, made as it makes
    them (numpy, seed 0): 4096 centres x 3, N // 4096 rows of unit noise
    about each (999,424 rows), 1024 queries = random rows + 0.1 noise; its
    width d = 128 unless another is asked for."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4096, d)).astype(np.float32) * 3
    x = np.concatenate([c + rng.standard_normal((BATCHED_N // 4096, d)).astype(np.float32)
                        for c in centers])[:BATCHED_N]
    q = x[rng.choice(BATCHED_N, 1024, replace=False)] + 0.1 * rng.standard_normal(
        (1024, d)).astype(np.float32)
    return x, q


def phase3_batched() -> dict:
    """Batched IVF at the JAX package's point: an IVFIndex (nlist 1024,
    nprobe 4) over benchmarks/ivf_batched_1m.py's data with an f32 and a
    bf16 table, at each Q of BATCHED_Q: search_batched through the user's
    entry point (launch counts set to 0 just before, read just after: the
    plan's probed-scan route, group_order with the bucket route, the
    select), both probed-scan routes bit-equal and within score_tol of the
    plain version and timed beside the distinct buckets' byte bound, and
    ivf_probed_topk's ids equal to the plain route's and, bit for bit, to
    the other scan route's."""
    import torch

    from image_search_engine_tpu_torch.index.ivf import IVFIndex
    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import topk as T

    log(f"phase 3: batched IVF at the JAX package's point ({BATCHED_N:,} x {BATCHED_D}, nlist "
        f"{BATCHED_NLIST}, nprobe {BATCHED_NPROBE}, k = {BATCHED_K})")
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    t0 = time.perf_counter()
    x, queries = batched_ivf_data()
    log(f"  data ({x.shape[0]:,} rows) made in {time.perf_counter() - t0:.1f} s")
    out = {}
    for dtype in ("f32", "bf16"):
        t0 = time.perf_counter()
        index = IVFIndex("l2", nlist=BATCHED_NLIST, nprobe=BATCHED_NPROBE, table_dtype=dtype,
                         device="cuda").add(x)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        nprobe = index._effective_nprobe()
        bc, lists, table, norms = index._device_arrays()
        nb, cap, _ = table.shape
        log(f"  IVFIndex ({dtype} table): {nb} buckets of cap {cap}, {nprobe} probed, built in "
            f"{build_s:.1f} s")
        per_q = {}
        for nq in BATCHED_Q:
            plan = IV.probed_scan_plan(nq, nprobe, nb, cap, BATCHED_D, table.element_size())
            T.reset_launch_counts()
            reset_scan_counts()
            _, ids = index.search_batched(queries[:nq], BATCHED_K)
            launches = {"slot": IV.probed_scan.slot_launches,
                        "bucket": IV.probed_scan.bucket_launches,
                        "group_order": T.group_order.launches,
                        "select_topt": T.select_topt.radix_launches}
            note_extract_min(f"batched IVF {dtype} Q={nq}")
            bucket = int(plan.route == "bucket")
            if launches != {"slot": 1 - bucket, "bucket": bucket, "group_order": bucket,
                            "select_topt": 1}:
                raise AssertionError(f"batched IVF {dtype} Q={nq}: launches {launches} on the "
                                     f"{plan.route} route")
            q = index._prep(queries[:nq])
            probe = IV.rank_buckets(q, bc, nprobe).to(torch.int32).contiguous()
            res = check_probed_scan(f"batched {dtype} Q={nq}", q.to(table.dtype).contiguous(),
                                    table, norms, probe, flush, reps=10)
            d, i, ok = IV.ivf_probed_topk(q, bc, table, norms, lists, BATCHED_K, nprobe)
            if not np.array_equal(torch.where(ok, i, -1).cpu().numpy(), ids):
                raise AssertionError(f"batched IVF {dtype} Q={nq}: search_batched's ids differ "
                                     f"from ivf_probed_topk's")
            with scan_route("slot" if bucket else "bucket"):
                d2, i2, _ = IV.ivf_probed_topk(q, bc, table, norms, lists, BATCHED_K, nprobe)
            if not (torch.equal(i, i2) and torch.equal(d.view(torch.int32),
                                                       d2.view(torch.int32))):
                raise AssertionError(f"batched IVF {dtype} Q={nq}: the scan routes' top-k differ")
            rd, ri = plain_probed_topk(q, bc, table, norms, lists, BATCHED_K, nprobe)
            assert_same_topk(d.cpu().numpy(), i.cpu().numpy(), rd.cpu().numpy(),
                             ri.cpu().numpy(), 2 * res["tol"], f"batched IVF {dtype} Q={nq}")
            res["topk_ms"] = median_ms(lambda: IV.ivf_probed_topk(
                q, bc, table, norms, lists, BATCHED_K, nprobe), flush, 10)
            res["search_launches"] = launches
            log(f"  batched IVF {dtype} Q={nq}: search_batched launches {launches}; probed "
                f"top-{BATCHED_K} {res['topk_ms']:.4f} ms, ids = the plain route's and the other "
                f"scan route's")
            per_q[nq] = res
        out[dtype] = {"build_s": build_s, "nbuckets": nb, "cap": cap, "nprobe": nprobe,
                      "Q": per_q}
        del index, bc, lists, table, norms
        torch.cuda.empty_cache()
    return out


def phase3_entry(workdir: Path, paths: list) -> dict:
    """The IVF-PQ path through the entry points: the indexer CLI over phase
    2's PNGs, then the HTTP server; assign launches counted over the build,
    probed-scan and select launches over the served queries."""
    from image_search_engine_tpu_torch.ops import kmeans as KM

    log("phase 3: the IVF-PQ path (indexer CLI --index-type ivfpq -> HTTP server)")
    KM.assign.launches = 0
    art = index_corpus(workdir, "artifacts_ivfpq", "--index-type", "ivfpq", "--pq-rerank", "64")
    assign_launches = KM.assign.launches
    out = serve_and_query(art, "ivfpq", paths, "ivfpq", own_first=False)
    if type(out["engine"].index).__name__ != "IVFPQIndex":
        raise AssertionError(f"engine loaded {type(out['engine'].index).__name__}")
    used = ("probed_scan", "probed_scan_slot", "select_topt", "select_topt_radix")
    counts = {k: out["launches"][k] for k in (*used, "probed_scan_bucket")}
    # a served query takes the slot route (probed_scan_plan), and every
    # select the radix one
    if (assign_launches == 0 or not all(counts[k] for k in used) or counts["probed_scan_bucket"]
            or counts["select_topt"] != counts["select_topt_radix"]):
        raise AssertionError(f"a kernel did not launch, or off its route: assign "
                             f"{assign_launches} during the build, {counts} while serving")
    log(f"  {assign_launches} assign launches in the build; 8 queries ok (own file in the top "
        f"{K}, ranked first in {out['first']} of 8); launches while serving {counts}; request "
        f"latency p50 {out['p50_ms']:.2f} ms (client clock)")
    return {"assign_launches": assign_launches, "launches": counts, "first": out["first"],
            "p50_ms": out["p50_ms"]}


# ---------------------------------------------------------------------------
# Phase 4: the int8 store and the chi2 metric
# ---------------------------------------------------------------------------


def quantize_rows_np(x: np.ndarray):
    """The JAX package's ``quantize_rows_int8`` (index/store.py), copied in
    numpy: (codes int8, scales f32)."""
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=1)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def check_quantization(gen) -> None:
    """100,000 x 2048 rows quantized on the card and by the numpy formula:
    codes and scales bit-identical. Row 0 is zero; row 1 has amax 127
    (scale 1) and exact .5 ties, which round half to even."""
    import torch

    from image_search_engine_tpu_torch.index.store import quantize_rows_int8

    x = torch.randn(100_000, 2048, device="cuda", generator=gen) * 3
    x[0] = 0.0
    x[1, :7] = torch.tensor([127.0, 0.5, 1.5, 2.5, 3.5, -2.5, -126.5], device="cuda")
    codes, scales = quantize_rows_int8(x)
    want_c, want_s = quantize_rows_np(x.cpu().numpy())
    got_c, got_s = codes.cpu().numpy(), scales.cpu().numpy()
    if not (np.array_equal(got_c, want_c) and np.array_equal(got_s.view(np.int32),
                                                            want_s.view(np.int32))):
        raise AssertionError(f"int8 quantization differs from the numpy formula: "
                             f"{int((got_c != want_c).sum())} codes, "
                             f"{int((got_s != want_s).sum())} scales")
    if got_c[1, :7].tolist() != [127, 0, 2, 2, 4, -2, -126]:
        raise AssertionError(f"half-to-even rounding: {got_c[1, :7]}")
    log("  quantization: 100,000 x 2048 rows on the card, codes and scales bit-identical to "
        "the numpy formula (zero row, .5 ties to even)")


def exact_err(name: str, kernel: str, a, b) -> float:
    """The kernel's output must equal its plain version's bit for bit
    (exact int32 sums, one f32 epilogue order); returns the error, 0."""
    err = max_abs_err(a, b)
    if err != 0.0:
        raise AssertionError(f"{name}: {kernel} differs from its plain version by {err} (want 0)")
    return err


def check_search_q8(name, index, q):
    """FlatIndex.search on an int8 store against the plain full scan that
    scores the round-tripped query against the dequantized store in f32
    (the JAX package's XLA path); all certificates True. Returns (query as
    searched, int8 query, query scales as the kernels take them, kernel
    norms)."""
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops.distances import l2_normalize
    from image_search_engine_tpu_torch.parallel.topk import ip_penalty, local_topk_with_norms

    st = index.store
    metric = "l2" if index.metric == "l2" else "ip"
    qs = l2_normalize(q) if index.metric == "cosine" else q
    di, ii = index.search(q, K)
    rd, ri = local_topk_with_norms(qs, st.vectors, st.norms, K, metric, scales=st.scales)
    assert_same_topk(di, ii, rd.cpu().numpy(), ri.cpu().numpy(), 2 * score_tol(qs, st.norms),
                     f"{name} search")
    _, _, cert = T.topk_twophase(qs, st.vectors, K, metric, x_norms=st.norms, x_scale=st.scales,
                                 with_certificate=True)
    if not bool(cert.all()):
        raise AssertionError(f"{name}: certificate failed for {int((~cert).sum())} queries")
    qi, qscale = T.quantize_int8(qs)
    if metric == "ip":
        return qs, qi, qscale * 0.5, ip_penalty(st.norms)
    return qs, qi, qscale, st.norms


def check_kernels_q8(name, qi, qscale, store, scales, knorms):
    """Both int8 kernels against their plain versions on the same inputs,
    bit for bit, and a group's phase-1 min equal to the min of its phase-2
    scores. Returns ({kernel: max_abs_err}, mins, candidate ids, t)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    errs = {}
    mins = T.groupmin_q8(qi, qscale, store, scales, knorms)
    errs["groupmin_q8"] = exact_err(name, "groupmin_q8", mins,
                                    T.groupmin_q8_ref(qi, qscale, store, scales, knorms))
    t = min(K + 4, mins.shape[1])
    _, ids = T.select_topt(mins, t)
    scores = T.rescore_q8(qi, qscale, store, scales, knorms, ids)
    errs["rescore_q8"] = exact_err(name, "rescore_q8", scores,
                                   T.rescore_q8_ref(qi, qscale, store, scales, knorms, ids))
    if not torch.equal(scores.view(qi.shape[0], t, -1).amin(2), torch.gather(mins, 1, ids.long())):
        raise AssertionError(f"{name}: phase-1 group mins differ from phase-2 scores")
    return errs, mins, ids, t


@contextlib.contextmanager
def q8_kernel(route: str):
    """groupmin_q8 on one of its two kernels whatever the batch size: "dp4a"
    (the CUDA-core sweep) or "mma" (the tensor-core sweep); the wrapper picks
    by ``DP4A_MAX_Q``, which this sets for the duration."""
    from image_search_engine_tpu_torch.ops import topk as T

    keep = T.DP4A_MAX_Q
    T.DP4A_MAX_Q = sys.maxsize if route == "dp4a" else 0
    try:
        yield
    finally:
        T.DP4A_MAX_Q = keep


def check_group_order(name, cand, ng, flush) -> dict:
    """group_order against its plain version (a stable argsort): a
    permutation of the slots whose group sequence is the plain version's
    (the order within a group is free), the bins' ends and the list of bins
    that have slots equal to the plain version's, timed beside its plain
    version and torch.argsort of the ids; bound: the ids read, the order,
    the ends and the list written."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    got, ref = T.group_order(cand, ng), T.group_order_ref(cand, ng)
    flat = cand.view(-1)
    bins = flat.clamp(-1, ng)  # ids below 0 share a bin, as do those of ng or more
    nlive = int(ref.live[0])
    if not (torch.equal(torch.sort(got.order).values,
                        torch.arange(flat.numel(), device="cuda", dtype=torch.int32))
            and torch.equal(bins[got.order.long()], bins[ref.order.long()])
            and torch.equal(got.ends, ref.ends)
            and torch.equal(got.live[:1 + nlive], ref.live[:1 + nlive])):
        raise AssertionError(f"{name}: group_order does not group the slots as its plain version")
    b = bound(flat.numel() * 8 + (ng + 2) * 4 + (1 + nlive) * 4, 0, F32_FLOPS)
    return {"max_abs_err": 0.0, "ms": median_ms(lambda: T.group_order(cand, ng), flush),
            "device_ms": graph_ms(lambda: T.group_order(cand, ng), flush),
            "plain_ms": median_ms(lambda: T.group_order_ref(cand, ng), flush),
            "library_ms": median_ms(lambda: torch.argsort(flat), flush),
            "bound_ms": b[0], "bound_by": b[1], "shape": f"{flat.numel()} slots, {ng} groups"}


@contextlib.contextmanager
def q8_rescore_order(group_order: bool):
    """rescore_q8 with its candidate slots in group order or in slot order,
    whatever the batch; the wrapper picks by RESCORE_Q8_GROUP_ORDER_MIN_SLOTS
    and the store's groups, which this overrides for the duration."""
    from image_search_engine_tpu_torch.ops import topk as T

    keep = T.RESCORE_Q8_GROUP_ORDER_MIN_SLOTS
    T.RESCORE_Q8_GROUP_ORDER_MIN_SLOTS = -sys.maxsize if group_order else sys.maxsize
    try:
        yield
    finally:
        T.RESCORE_Q8_GROUP_ORDER_MIN_SLOTS = keep


def check_shape_q8(name, x, nq, metric, gen, flush, *, pad_rows=None, q_scale=1.0,
                   int_mm_rows=0, routes=(), rescore_orders=False):
    """One timed int8 shape: FlatIndex(dtype="int8") over x, the search and
    both kernels checked, then each kernel and its plain version timed.
    ``int_mm_rows`` > 0 also times ``torch._int_mm``'s int8 product of the
    queries with that many store rows (the product alone, a yardstick).
    ``routes``: batch sizes at which both groupmin_q8 kernels (CUDA cores,
    tensor cores) run on new queries, each bit for bit equal to the plain
    version, and are timed (where the wrapper's DP4A_MAX_Q should lie).
    ``rescore_orders``: rescore_q8 also with its slots in group order and in
    slot order, bit for bit equal to its plain version, with its device
    time; group_order checked and timed. Returns {kernel:
    {max_abs_err, ms, device_ms, plain_ms, library_ms, bound_ms, bound_by}}
    and, with ``int_mm_rows``, "int_mm_ms", with ``routes``, "routes" {Q:
    {route: ms}}, with ``rescore_orders``, rescore_q8's "device_ms_by_order"
    {plan: ms}."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM, local_topk_with_norms

    q = torch.randn(nq, x.shape[1], device="cuda", generator=gen) * q_scale
    index = FlatIndex(metric, dtype="int8", device="cuda").add(x)
    del x
    st = index.store
    store, norms, scales = st.vectors, st.norms, st.scales
    if pad_rows is not None:  # poison rows inside the store (zero codes, zero scale)
        store[pad_rows] = 0
        scales[pad_rows] = 0.0
        norms[pad_rows] = PAD_NORM
    T.group_order.launches = 0
    qs, qi, qscale, knorms = check_search_q8(name, index, q)
    order_launches = T.group_order.launches  # the searches' slot orders (Q t >= threshold)
    if pad_rows is not None and np.isin(index.search(q, K)[1], pad_rows.cpu().numpy()).any():
        raise AssertionError(f"{name}: a PAD_NORM row was returned")
    errs, mins, ids, t = check_kernels_q8(name, qi, qscale, store, scales, knorms)

    nq, d = qi.shape
    n, ng = store.shape[0], mins.shape[1]
    rows = torch.unique(ids).numel() * T.GROUP  # distinct candidate rows this run reads
    bounds = {
        "groupmin_q8": bound(n * (d + 8) + nq * (d + 4) + nq * ng * 4, 2 * nq * n * d, INT8_OPS),
        "rescore_q8": bound(rows * (d + 8) + nq * (d + 4) + nq * t * (4 + T.GROUP * 4),
                            2 * nq * t * T.GROUP * d, INT8_OPS),
    }
    res = {}
    for kname, fn, ref in (
        ("groupmin_q8", lambda: T.groupmin_q8(qi, qscale, store, scales, knorms),
         lambda: T.groupmin_q8_ref(qi, qscale, store, scales, knorms)),
        ("rescore_q8", lambda: T.rescore_q8(qi, qscale, store, scales, knorms, ids),
         lambda: T.rescore_q8_ref(qi, qscale, store, scales, knorms, ids)),
    ):
        res[kname] = {"max_abs_err": errs[kname], "ms": median_ms(fn, flush),
                      "device_ms": graph_ms(fn, flush),
                      "plain_ms": median_ms(ref, flush, reps=5), "library_ms": None,
                      "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    extra = ""
    if rescore_orders:
        res["group_order"] = check_group_order(name, ids, ng, flush)
        res["group_order"]["search_launches"] = order_launches
        want = T.rescore_q8_ref(qi, qscale, store, scales, knorms, ids)
        orders = {}
        for label, grouped in (("slot_order", False), ("group_order", True)):
            with q8_rescore_order(grouped):
                exact_err(f"{name} ({label})", "rescore_q8",
                          T.rescore_q8(qi, qscale, store, scales, knorms, ids), want)
                orders[label] = graph_ms(
                    lambda: T.rescore_q8(qi, qscale, store, scales, knorms, ids), flush)
        res["rescore_q8"]["device_ms_by_order"] = orders
        go = res["group_order"]
        extra += "; rescore_q8 device ms by order " + ", ".join(
            f"{k} {v:.4f}" for k, v in orders.items()) + (
            f"; group_order = plain, {go['ms']:.4f} ms (device {go['device_ms']:.4f}; plain "
            f"{go['plain_ms']:.4f}, torch.argsort {go['library_ms']:.4f}), {go['search_launches']}"
            f" launches in the searches")
    if routes:
        res["routes"] = {}
        for rq in routes:
            ri, rs = T.quantize_int8(torch.randn(rq, d, device="cuda", generator=gen))
            want = T.groupmin_q8_ref(ri, rs, store, scales, knorms)
            res["routes"][rq] = {}
            for route in ("dp4a", "mma"):
                with q8_kernel(route):
                    got = T.groupmin_q8(ri, rs, store, scales, knorms)
                    exact_err(f"{name} Q={rq}", f"groupmin_q8 ({route})", got, want)
                    res["routes"][rq][route] = median_ms(
                        lambda: T.groupmin_q8(ri, rs, store, scales, knorms), flush)
        extra += "; groupmin_q8 by kernel (CUDA cores / tensor cores): " + ", ".join(
            f"Q={rq} {v['dp4a']:.4f} / {v['mma']:.4f} ms" for rq, v in res["routes"].items())
    smetric = "l2" if metric == "l2" else "ip"
    search_ms = median_ms(lambda: T.topk_twophase(qs, store, K, smetric, x_norms=norms,
                                                  x_scale=scales), flush)
    scan_ms = median_ms(lambda: local_topk_with_norms(qs, store, norms, K, smetric,
                                                      scales=scales), flush, reps=5)
    if int_mm_rows:
        try:
            res["int_mm_ms"] = median_ms(lambda: torch._int_mm(qi, store[:int_mm_rows].t()), flush)
            extra += (f"; torch._int_mm product alone (Q={nq} x {int_mm_rows:,} rows) "
                      f"{res['int_mm_ms']:.4f} ms")
        except RuntimeError as e:  # a yardstick only: record why it is missing
            res["int_mm_ms"] = None
            extra += f"; torch._int_mm refused: {e}"
    log(f"  {name}: " + "; ".join(
        f"{k} err {v['max_abs_err']:.3g} {v['ms']:.4f} ms (device {v['device_ms']:.4f} ms; plain "
        f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms by {v['bound_by']})"
        for k, v in res.items() if k in ("groupmin_q8", "rescore_q8"))
        + f"; two-phase search {search_ms:.4f} ms, plain full scan {scan_ms:.4f} ms" + extra)
    return res


def edge_sweep_q8(gen) -> None:
    """Phase 1's edge shapes over an int8 store, untimed. Through FlatIndex
    (the search, its certificate and both kernels): partial query tiles (Q
    in {1, 2, 3, 9, 15, 16, 17, 33, 129}), rows that are not 16-byte
    multiples (d = 130, 2049: the narrower copies), a one-group store,
    ragged last groups; l2, ip and cosine; and one Q = 4096 batch over
    20,000 x 128 (ip). Then the tensor-core sweep's tile edges on quantized
    rows directly: N in {1, 127, 128, 129, 5000} x Q in {1, 15, 16, 17, 33,
    129} x d in {16, 130, 2049}, l2 and ip in turn (ip: the query scale
    halved, zero norms, 10% of the rows poisoned with PAD_NORM). Every
    kernel output equals its plain version bit for bit, every group min
    the min of its rescored rows."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM, ip_penalty

    def through_index(metric, n, d, nq):
        x = torch.randn(n, d, device="cuda", generator=gen)
        q = torch.randn(nq, d, device="cuda", generator=gen)
        index = FlatIndex(metric, dtype="int8", device="cuda").add(x)
        name = f"edge N={n} d={d} Q={nq} int8 {metric}"
        _, qi, qscale, knorms = check_search_q8(name, index, q)
        check_kernels_q8(name, qi, qscale, index.store.vectors, index.store.scales, knorms)

    cases = 0
    for metric in ("l2", "ip", "cosine"):
        for n, d, nq in ((100, 16, 1), (1000, 130, 3), (3000, 256, 2), (5003, 2049, 9),
                         (20_000, 64, 17), (5000, 130, 15), (129, 2048, 16), (128, 2049, 33),
                         (4000, 256, 129)):
            through_index(metric, n, d, nq)
            cases += 1
    through_index("ip", 20_000, 128, 4096)
    cases += 1
    tiles = [(n, nq, d) for n in (1, 127, 128, 129, 5000) for nq in (1, 15, 16, 17, 33, 129)
             for d in (16, 130, 2049)]
    for n, nq, d in tiles:
        codes, scales = T.quantize_int8(torch.randn(n, d, device="cuda", generator=gen))
        qi, qscale = T.quantize_int8(torch.randn(nq, d, device="cuda", generator=gen))
        deq = codes.float() * scales[:, None]
        norms = (deq * deq).sum(1)
        if cases % 2:
            norms[torch.rand(n, device="cuda", generator=gen) < 0.1] = PAD_NORM
            qscale, knorms = qscale * 0.5, ip_penalty(norms)
        else:
            knorms = norms
        check_kernels_q8(f"int8 tile edge N={n} Q={nq} d={d}", qi, qscale, codes, scales, knorms)
        cases += 1
    log(f"  int8 edge sweep: {cases} shapes ok (l2, ip with PAD_NORM rows, cosine), every "
        f"kernel output equal to its plain version, group mins = rescored rows' mins bit for bit")


def bench_point_q8(store, flush) -> dict:
    """bench.py's store (seed 0, 1M x 128) quantized by the int8 FlatIndex
    (quantize_rows_int8) and Q = 2048 of its queries, quantized, l2: a
    compute-bound point for groupmin_q8 (2 Q N d operations against 128 MB
    of codes). The kernel against its plain version bit for bit (512
    queries at a time), then timed beside its plain version, the CUDA-core
    sweep it replaced at such batches and torch._int_mm's int8 product
    alone over the same rows (a yardstick)."""
    import torch

    from image_search_engine_tpu_torch.benchmarks import common
    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.ops import topk as T

    st = FlatIndex("l2", dtype="int8", device="cuda").add(store.x32).store
    codes, scales, norms = st.vectors, st.scales, st.norms
    qi, qscale = T.quantize_int8(common.queries(store, 1, PROTO_Q)[0])
    name = f"int8 bench point Q={PROTO_Q} N={BENCH_N:,} d={BENCH_D}"
    mins = T.groupmin_q8(qi, qscale, codes, scales, norms)
    for s in range(0, PROTO_Q, 512):
        sl = slice(s, s + 512)
        exact_err(name, "groupmin_q8", mins[sl],
                  T.groupmin_q8_ref(qi[sl], qscale[sl], codes, scales, norms))
    del mins
    nq, d = qi.shape
    n, ng = codes.shape[0], T.num_groups(codes.shape[0])
    b = bound(n * (d + 8) + nq * (d + 4) + nq * ng * 4, 2 * nq * n * d, INT8_OPS)
    res = {"max_abs_err": 0.0, "bound_ms": b[0], "bound_by": b[1],
           "ms": median_ms(lambda: T.groupmin_q8(qi, qscale, codes, scales, norms), flush,
                           reps=5),
           "plain_ms": median_ms(lambda: T.groupmin_q8_ref(qi, qscale, codes, scales, norms),
                                 flush, reps=2),
           "int_mm_ms": median_ms(lambda: torch._int_mm(qi, codes.t()), flush, reps=5),
           "shape": f"Q={nq} N={n:,} d={d} int8 l2 (bench.py's store)"}
    with q8_kernel("dp4a"):
        res["dp4a_ms"] = median_ms(lambda: T.groupmin_q8(qi, qscale, codes, scales, norms),
                                   flush, reps=3)
    log(f"  {name}: groupmin_q8 err 0, {res['ms']:.4f} ms (plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}; the CUDA-core sweep "
        f"{res['dp4a_ms']:.4f} ms); torch._int_mm product alone {res['int_mm_ms']:.4f} ms")
    return res


def phase4_kernels() -> dict:
    import torch

    log("phase 4: the int8 store and its kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    check_quantization(gen)
    shapes = {}
    x = torch.randn(1_000_000, 2048, device="cuda", generator=gen)
    shapes["Q1_N1M_d2048_int8_l2"] = check_shape_q8("Q=1 N=1,000,000 d=2048 int8 l2", x, 1,
                                                    "l2", gen, flush, routes=(1, 4, 8, 16),
                                                    rescore_orders=True)
    del x
    torch.cuda.empty_cache()
    x = torch.randn(200_003, 2048, device="cuda", generator=gen)
    shapes["Q64_N200003_d2048_int8_ip"] = check_shape_q8(
        "Q=64 N=200,003 d=2048 int8 ip", x, 64, "ip", gen, flush, int_mm_rows=200_000,
        rescore_orders=True)
    # a batch past RESCORE_Q8_GROUP_ORDER_MIN_SLOTS: the rescore in group order
    shapes["Q256_N200003_d2048_int8_ip"] = check_shape_q8(
        "Q=256 N=200,003 d=2048 int8 ip", x, 256, "ip", gen, flush, rescore_orders=True)
    if shapes["Q256_N200003_d2048_int8_ip"]["group_order"]["search_launches"] == 0:
        raise AssertionError("Q=256 int8 search: the rescore's group order did not launch")
    del x
    base = torch.randn(25_000, 2048, device="cuda", generator=gen)
    x = base[torch.randint(0, 25_000, (100_000,), device="cuda", generator=gen)]
    shapes["ties_Q8_N100000_d2048_int8_l2"] = check_shape_q8(
        "tie-heavy Q=8 N=100,000 d=2048 int8 l2 (rows duplicated ~4x)", x, 8, "l2", gen, flush)
    del x, base
    x = torch.randn(100_000, 2048, device="cuda", generator=gen) * 10
    pads = torch.randperm(100_000, device="cuda", generator=gen)[:10_000]
    shapes["pad_Q4_N100000_d2048_int8_l2"] = check_shape_q8(
        "PAD_NORM rows Q=4 N=100,000 d=2048 int8 l2 (10% poisoned, queries at the origin)",
        x, 4, "l2", gen, flush, pad_rows=pads, q_scale=1e-3)
    del x
    torch.cuda.empty_cache()
    edge_sweep_q8(gen)
    return shapes


def phase4_entry(workdir: Path, paths: list, flat_art: Path) -> dict:
    """The int8 store and the chi2 metric through the entry points: the
    indexer CLI over phase 2's PNGs with ``--store-dtype int8 --index-type
    l2``, then with ``--index-type chi2``, each served over HTTP. The int8
    path launches groupmin_q8, select_topt and rescore_q8 once per request
    and nothing else of the flat search; chi2 launches no kernel."""
    from image_search_engine_tpu_torch.index.flat import FlatIndex

    log("phase 4: the int8 and chi2 paths (indexer CLI -> HTTP server)")
    art = index_corpus(workdir, "artifacts_int8", "--index-type", "l2", "--store-dtype", "int8")
    q8 = serve_and_query(art, "l2", paths, "int8")
    idx8 = q8["engine"].index
    want = {"groupmin": 0, "select_topt": 8, "rescore": 0, "groupmin_q8": 8, "rescore_q8": 8,
            "group_order": 0, "topk_running": 0, "select_topt_radix": 8, "probed_scan": 0,
            "probed_scan_slot": 0, "probed_scan_bucket": 0}
    if idx8.dtype != "int8" or q8["launches"] != want or q8["escalations"] != 0:
        raise AssertionError(f"int8 serving: store {idx8.dtype}, launches {q8['launches']} (want "
                             f"{want}), escalations {q8['escalations']}")
    # the int8 store's top-10 against the f32 index's over the same embeddings
    f32 = FlatIndex.load(flat_art / "dnn_resnet50_l2.index.npz", device="cuda")
    queries = f32.store.values()[::64]
    _, i32 = f32.search(queries, 10)
    _, i8 = idx8.search(queries, 10)
    overlap = float(np.mean([len(set(a) & set(b)) / 10
                             for a, b in zip(i32.tolist(), i8.tolist())]))
    log(f"  int8: 8 queries ok (top-1 = the query's own file); launches while serving "
        f"{q8['launches']}; request latency p50 {q8['p50_ms']:.2f} ms (client clock); "
        f"certificate escalations {q8['escalations']}; top-10 overlap with the f32 index "
        f"{overlap:.4f} ({queries.shape[0]} stored embeddings as queries)")

    art = index_corpus(workdir, "artifacts_chi2", "--index-type", "chi2")
    c2 = serve_and_query(art, "chi2", paths, "chi2")
    if c2["engine"].index.metric != "chi2" or any(c2["launches"].values()):
        raise AssertionError(f"chi2 serving: metric {c2['engine'].index.metric}, launches "
                             f"{c2['launches']} (want none)")
    log(f"  chi2: 8 queries ok (top-1 = the query's own file); no kernel launched; request "
        f"latency p50 {c2['p50_ms']:.2f} ms (client clock)")
    return {"launches": q8["launches"], "p50_ms": q8["p50_ms"], "overlap": overlap,
            "escalations": q8["escalations"], "chi2_p50_ms": c2["p50_ms"]}


# ---------------------------------------------------------------------------
# Phase 5: the last two package kernels (running top-k, merged two-phase)
# ---------------------------------------------------------------------------

MERGED_MARGIN = 2  # topk_merged's default, held against topk_twophase at the same margin
# bench.py's operating point: 1M x 128 bf16, k = 10, Q = 2048 and 4096
BENCH_N, BENCH_D, BENCH_K = 1_000_000, 128, 10


def search_inputs(q, x, metric):
    """(query, store, the store's own squared norms) after the entry
    points' cosine normalization."""
    from image_search_engine_tpu_torch.ops import topk as T

    q, x, _ = T._cosine_as_ip(q, x, metric)
    return q, x, (x.float() * x.float()).sum(1)


def running_tol(q, x, metric) -> float:
    """score_tol for topk_running: its f32 query (halved for ip) against
    the store's own norms."""
    q, x, sn = search_inputs(q, x, metric)
    return score_tol(q.float() * (1.0 if metric == "l2" else 0.5), sn)


def assert_ids_equal(name, i, ri, rd, tol) -> int:
    """The kernel's ids equal the plain version's, except at positions
    whose plain distance lies within tol of a neighbour's without being
    equal to it (a near-tie that the summation order may flip). Returns how
    many positions differ (expected 0)."""
    bad = (i != ri).cpu().numpy()
    if not bad.any():
        return 0
    rdn = rd.double().cpu().numpy()
    step = np.abs(np.diff(rdn, axis=1))
    gap = np.full(rdn.shape, np.inf)
    gap[:, 1:] = step
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    near = (gap <= tol) & (gap > 0)
    if (bad & ~near).any():
        r, c = np.argwhere(bad & ~near)[0]
        raise AssertionError(f"{name}: ids differ from the plain version's at query {r} rank {c}: "
                             f"{int(i[r, c])} vs {int(ri[r, c])} (plain distance {rdn[r, c]}, "
                             f"tolerance {tol})")
    return int(bad.sum())


def check_running(name, q, x, k, metric, *, x_norms=None, got=None):
    """topk_running (``got``, or run now) against topk_running_ref on the
    same tensors: ids equal, distances within 2 score_tol. Returns (max abs
    error, near-tie positions)."""
    from image_search_engine_tpu_torch.ops import topk as T

    if got is None:
        got = T.topk_running(q, x, k, metric, x_norms=x_norms)
    rd, ri = T.topk_running_ref(q, x, k, metric, x_norms=x_norms)
    tol = 2 * running_tol(q, x, metric)
    err = max_abs_err(got[0], rd)
    if err > tol:
        raise AssertionError(f"{name}: topk_running distances differ by {err} > {tol}")
    return err, assert_ids_equal(name, got[1], ri, rd, tol)


def check_merged(name, q, x, k, metric, *, x_norms=None, got=None, plain=True):
    """topk_merged (``got``, or run now) against topk_twophase at the same
    margin: where both score on CUDA cores (f32, up to F32_CUDA_CORE_MAX_Q
    queries) equal bit for bit (distances, ids, certificate); where the
    two-phase search scores on tensor cores (bf16; f32 beyond that) while
    topk_merged keeps row_dot, distances within 2 score_tol, ids equal but
    at near-ties, and both certificates all True.
    Every certificate True; then its kernel wrapper: each candidate group's
    stage-1 min equal to the min of its stage-3 rows, and (``plain``) mins
    and scores against the plain version. Returns the largest kernel error
    (0.0 unchecked)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops import topk_merged as TM

    if got is None:
        got = TM.topk_merged(q, x, k, metric, x_norms=x_norms, with_certificate=True)
    want = T.topk_twophase(q, x, k, metric, x_norms=x_norms, t_margin=MERGED_MARGIN,
                           with_certificate=True)
    qs, xs, sn = search_inputs(q, x, metric)
    smetric = "l2" if metric == "l2" else "ip"
    qf = qs.to(xs.dtype).contiguous() * (1.0 if smetric == "l2" else 0.5)
    if x.dtype == torch.bfloat16 or f32_route(x, q.shape[0]) == "mma":
        tol = 2 * score_tol(qf, sn)
        derr = max_abs_err(got[0], want[0])
        if derr > tol:
            raise AssertionError(f"{name}: topk_merged distances differ from topk_twophase's by "
                                 f"{derr} > {tol}")
        assert_ids_equal(f"{name} topk_merged vs topk_twophase", got[1], want[1], want[0], tol)
        if not bool(want[2].all()):
            raise AssertionError(f"{name}: {int((~want[2]).sum())} topk_twophase certificates "
                                 "failed")
    else:
        for what, a, b in zip(("distances", "ids", "certificates"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: topk_merged {what} differ from topk_twophase's")
    if not bool(got[2].all()):
        raise AssertionError(f"{name}: {int((~got[2]).sum())} certificates failed")
    norms = T._search_norms(xs, smetric, x_norms)
    t = min(k + MERGED_MARGIN, T.num_groups(xs.shape[0]))
    scores, cand, _, mins = TM.merged_candidates(qf, xs, norms, t)
    if not torch.equal(scores.view(qf.shape[0], t, -1).amin(2), mins.gather(1, cand.long())):
        raise AssertionError(f"{name}: stage-1 group mins differ from the stage-3 rows' mins")
    if not plain:
        return 0.0
    tol = score_tol(qf, sn)
    err = max(max_abs_err(mins, T.groupmin_ref(qf, xs, norms)),
              max_abs_err(scores, T.rescore_ref(qf, xs, norms, cand)))
    if err > tol:
        raise AssertionError(f"{name}: merged kernel error {err} > tolerance {tol}")
    return err


def edge_sweep_phase5(gen) -> dict:
    """Small shapes at both kernels' edges, untimed. topk_running: k in {1,
    20, 128} x N in {1, 127, 128, 129, 5000} (k > N included), metrics,
    dtypes, query tiles and row widths (d = 130: scalar loads) rotating;
    ip with PAD_NORM rows; a tie-heavy store. topk_merged: a store of fewer
    groups than k + margin (every group rescored), ragged groups, Q > 8,
    d = 130; f32 and bf16, l2 and ip. Returns the largest errors."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

    worst, near, cases = 0.0, 0, 0
    rot = [("l2", torch.float32, 1, 16), ("ip", torch.bfloat16, 3, 130),
           ("cosine", torch.float32, 9, 64), ("l2", torch.bfloat16, 8, 2048)]
    for k in (1, 20, 128):
        for n in (1, 127, 128, 129, 5000):
            metric, dtype, nq, d = rot[cases % len(rot)]
            x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
            q = torch.randn(nq, d, device="cuda", generator=gen)
            e, c = check_running(f"running edge k={k} N={n} Q={nq} d={d} {dtype} {metric}",
                                 q, x, k, metric)
            worst, near, cases = max(worst, e), near + c, cases + 1
    x = -torch.randn(5000, 64, device="cuda", generator=gen).abs()
    pads = torch.randperm(5000, device="cuda", generator=gen)[:500]
    x[pads] = 0.0
    norms = (x * x).sum(1)
    norms[pads] = PAD_NORM
    q = torch.randn(4, 64, device="cuda", generator=gen).abs()
    got = T.topk_running(q, x, 50, "ip", x_norms=norms)
    if torch.isin(got[1], pads).any():
        raise AssertionError("running edge: a PAD_NORM row was returned under ip")
    e, c = check_running("running edge ip PAD_NORM", q, x, 50, "ip", x_norms=norms, got=got)
    worst, near = max(worst, e), near + c
    base = torch.randn(1250, 256, device="cuda", generator=gen)
    x = base[torch.randint(0, 1250, (5000,), device="cuda", generator=gen)]
    q = torch.randn(8, 256, device="cuda", generator=gen)
    e, c = check_running("running edge tie-heavy", q, x, 128, "l2")
    worst, near, cases = max(worst, e), near + c, cases + 2

    mworst, mcases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for metric in ("l2", "ip"):
            for n, d, nq, k in ((300, 16, 4, 10), (5003, 130, 9, 20), (20_000, 64, 17, 128)):
                x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
                q = torch.randn(nq, d, device="cuda", generator=gen)
                mworst = max(mworst, check_merged(f"merged edge N={n} d={d} Q={nq} k={k} {dtype} "
                                                  f"{metric}", q, x, k, metric))
                mcases += 1
    log(f"  edge sweeps: topk_running {cases} shapes, ids equal to the plain version's "
        f"({near} near-tie positions), largest error {worst:.3g}; topk_merged {mcases} shapes "
        f"equal to topk_twophase (bit for bit where both score f32 on CUDA cores, else within "
        f"tolerance), largest kernel error {mworst:.3g}")
    return {"topk_running": worst, "topk_merged": mworst}


def phase5() -> dict:
    """topk_running and topk_merged through their entry points: every call
    of the main run (launch counts set to 0 just before, read just after),
    then each checked and timed beside topk_twophase, then the edge
    sweeps."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops import topk_merged as TM

    log("phase 5: the running top-k and the merged two-phase search")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    x32 = torch.randn(1_000_000, 2048, device="cuda", generator=gen)
    xb = x32.to(torch.bfloat16)
    bench = torch.randn(BENCH_N, BENCH_D, device="cuda", generator=gen).to(torch.bfloat16)
    stores = {name: (x, (x.float() * x.float()).sum(1))
              for name, x in (("f32", x32), ("bf16", xb), ("bench", bench))}
    q64 = torch.randn(64, 2048, device="cuda", generator=gen)
    q4096 = torch.randn(4096, BENCH_D, device="cuda", generator=gen)
    running_cases = {"Q1_f32": ("f32", q64[:1]), "Q8_f32": ("f32", q64[:8]),
                     "Q1_bf16": ("bf16", q64[:1])}
    merged_cases = {"Q1_f32": ("f32", q64[:1], K), "Q64_f32": ("f32", q64, K),
                    "Q1_bf16": ("bf16", q64[:1], K), "Q64_bf16": ("bf16", q64, K),
                    "Q2048_bench": ("bench", q4096[:2048], BENCH_K),
                    "Q4096_bench": ("bench", q4096, BENCH_K)}
    torch.cuda.synchronize()

    T.reset_launch_counts()
    TM.merged_candidates.launches = 0
    running_out = {c: T.topk_running(q, stores[s][0], K, "l2", x_norms=stores[s][1])
                   for c, (s, q) in running_cases.items()}
    merged_out = {c: TM.topk_merged(q, stores[s][0], k, "l2", x_norms=stores[s][1],
                                    with_certificate=True)
                  for c, (s, q, k) in merged_cases.items()}
    torch.cuda.synchronize()
    launches = {"topk_running": T.topk_running.launches,
                "topk_merged": TM.merged_candidates.launches}
    if launches != {"topk_running": len(running_cases), "topk_merged": len(merged_cases)}:
        raise AssertionError(f"phase 5 entry-point calls launched {launches}")
    log(f"  entry-point calls: launches {launches} (one per call)")

    res = {"launches": launches, "running": {}, "merged": {}}
    for c, (s, q) in running_cases.items():
        x, norms = stores[s]
        err, near = check_running(f"running {c}", q, x, K, "l2", x_norms=norms,
                                  got=running_out[c])
        nq, isz = q.shape[0], x.element_size()
        b = bound(x.numel() * isz + x.shape[0] * 4 + q.numel() * 4 + nq * K * 8,
                  2 * nq * x.numel(), F32_FLOPS)
        r = {"max_abs_err": err, "near_ties": near, "bound_ms": b[0], "bound_by": b[1],
             "ms": median_ms(lambda: T.topk_running(q, x, K, "l2", x_norms=norms), flush),
             "plain_ms": median_ms(lambda: T.topk_running_ref(q, x, K, "l2", x_norms=norms),
                                   flush, reps=5),
             "twophase_ms": median_ms(lambda: T.topk_twophase(q, x, K, "l2", x_norms=norms),
                                      flush)}
        res["running"][c] = r
        log(f"  topk_running {c} (N={x.shape[0]:,} d={x.shape[1]} {str(x.dtype)[6:]} k={K}): "
            f"ids = plain ({near} near-ties), "
            f"err {err:.3g}; {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{b[0]:.4f} ms by {b[1]}); topk_twophase {r['twophase_ms']:.4f} ms")
    del running_out

    for c, (s, q, k) in merged_cases.items():
        x, norms = stores[s]
        nq, n, d = q.shape[0], x.shape[0], x.shape[1]
        fits = nq * n <= 2 ** 31  # the plain version's (Q, N) f32 scores
        err = check_merged(f"merged {c}", q, x, k, "l2", x_norms=norms, got=merged_out[c],
                           plain=fits)
        qf = q.to(x.dtype).contiguous()
        t = min(k + MERGED_MARGIN, T.num_groups(n))
        isz = x.element_size()
        b = bound(n * d * isz + n * 4 + nq * d * isz
                  + nq * (t * T.GROUP * 4 + t * 4 + 4 + T.num_groups(n) * 4),
                  2 * nq * n * d + 2 * nq * t * T.GROUP * d, F32_FLOPS if isz == 4 else BF16_FLOPS)
        reps = TIMING_REPS if nq <= 8 else 5
        r = {"max_abs_err": err, "bound_ms": b[0], "bound_by": b[1], "t": t,
             "ms": median_ms(lambda: TM.merged_candidates(qf, x, norms, t), flush, reps=reps),
             "search_ms": median_ms(lambda: TM.topk_merged(q, x, k, "l2", x_norms=norms), flush,
                                    reps=reps),
             "twophase_ms": median_ms(lambda: T.topk_twophase(q, x, k, "l2", x_norms=norms,
                                                              t_margin=MERGED_MARGIN), flush,
                                      reps=reps),
             "plain_ms": (median_ms(lambda: TM.merged_candidates_ref(qf, x, norms, t), flush,
                                    reps=3) if fits else None)}
        res["merged"][c] = r
        plain = "not timed: (Q, N) f32 too large" if r["plain_ms"] is None else \
            f"{r['plain_ms']:.4f} ms"
        same = ("bit for bit" if x.dtype == torch.float32 and f32_route(x, nq) == "cuda"
                else "within 2 score_tol, ids at near-ties")
        log(f"  topk_merged {c} (N={n:,} d={d} {str(x.dtype)[6:]} k={k}, t={t}): = "
            f"topk_twophase {same}, certificates all True, kernel err {err:.3g}; kernel "
            f"{r['ms']:.4f} ms (plain "
            f"{plain}, bound {b[0]:.4f} ms by {b[1]}); search {r['search_ms']:.4f} ms vs "
            f"topk_twophase(t_margin={MERGED_MARGIN}) {r['twophase_ms']:.4f} ms")
    del merged_out, stores, x32, xb, bench
    torch.cuda.empty_cache()
    res["edge"] = edge_sweep_phase5(gen)
    return res


# ---------------------------------------------------------------------------
# Phase 6: bench.py's operating point (the bench twin, the prototype kernels)
# ---------------------------------------------------------------------------

BENCH_Q, BENCH_ITERS, PROTO_Q = 4096, 100, 2048
PROTO_REPS = 20  # the tensor-core prototypes and groupmin: a few ms a call at Q = 2048
CUDA_CORE_REPS = 3  # the CUDA-core prototypes they replaced: ~0.2 s a call
SEARCH_REPS = 10  # each prototype script's search, and the shipped one
# the tie check: a store whose second half repeats its first, from a group
# boundary, so the two-phase search's tie order is the full scan's
TIE_HALF, TIE_D, TIE_Q = 65_536, 256, 16
SORT_N, SORT_D = 1_000_000, 2048  # the k > 128 full scan at the flat corpus scale


def bf16_ulps(a, b) -> float:
    """max |a - b| in units of b's bf16 spacing (2^(e-8) for |b| in [2^(e-1),
    2^e)); +inf must match +inf exactly."""
    import torch

    a, b = a.float(), b.float()
    max_abs_err(a, b)  # raises on +inf or NaN mismatches
    fin = torch.isfinite(b)
    if not fin.any():
        return 0.0
    _, e = torch.frexp(b[fin])
    ulp = torch.ldexp(torch.ones_like(b[fin]), e - 8)
    return float(((a[fin] - b[fin]).abs() / ulp).max().item())


def bench_point_registers() -> dict:
    """Registers a thread of the bf16 sweep's instantiations that bench.py's
    point launches (128-query tiles, 16-byte copies, the tile resident), by
    output policy, from the build's ptxas log; raises where one would leave
    room for one 256-thread block an SM, where the plan's shared memory
    gives two."""
    from image_search_engine_tpu_torch.ops import _kernels

    log = _kernels.library_path().with_suffix(".log").read_text()
    names = {"QueryMajorMins": "groupmin", "WidthMinsILi128E": "width128",
             "WidthMinsILi64E": "width64", "WidthMinsILi32E": "width32",
             "TwoLevelMinsILi0E": "two_level_v1", "TwoLevelMinsILi1E": "two_level_v2",
             "TwoLevelMinsILi2E": "two_level_v3"}
    regs = {}
    for fn, r in re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers", log,
                            re.S):
        if "groupmin_mma_kernel" in fn and "Li128ELi8ELb1E" in fn:
            regs.update({v: int(r) for k, v in names.items() if k in fn})
    if sorted(regs) != sorted(names.values()):
        raise AssertionError(f"bench point sweep instantiations not all in the ptxas log: {regs}")
    over = {k: r for k, r in regs.items() if r > 65536 // (2 * 256)}
    if over:
        raise AssertionError(f"bench point sweeps over 128 registers (one block an SM): {over}")
    return regs


def check_variants(name, qf, x, norms, nf32, *, route="mma", layouts=None, widths=None,
                   chunked=True):
    """The four prototype kernels on (qf, x), width and two-level on
    ``route``: each f32 output within score_tol of its plain version; width
    128 and every layout's two-level group mins equal to ``want`` bit for
    bit, which on the "mma" route is production ``groupmin(...).T`` (the
    prototypes are its sweep with another epilogue) and on the "cuda_core"
    route that route's own width-128 run (its row_dot kernels share one
    summation order; production is held within score_tol of it); the bf16
    subgroup mins within one bf16 ulp of the plain version's, and each group
    min's bf16 rounding equal to the min of its subgroup mins. ``norms``
    score the chunked kernel, ``nf32`` the others (the scripts' norms);
    ``widths`` (default all) and ``chunked`` pick kernels. Returns {kernel:
    max_abs_err} (the two-level's in bf16 ulps too; on the CUDA-core route
    ``groupmin_vs_row_dot``, production's distance from ``want``)."""
    import torch
    import torch.nn.functional as F

    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import topk as T

    errs = {}
    tol = score_tol(qf, torch.cat([norms, nf32]))
    production = T.groupmin(qf, x, nf32).T.contiguous()
    with variants_route(route):
        want = production if route == "mma" else GV.groupmin_width(qf, x, nf32, T.GROUP)
        if route == "cuda_core":
            errs["groupmin_vs_row_dot"] = max_abs_err(production, want)
        for g in GV.WIDTHS if widths is None else widths:
            got = GV.groupmin_width(qf, x, nf32, g)
            errs[f"width{g}"] = max_abs_err(got, GV.groupmin_width_ref(qf, x, nf32, g))
            if g == 128 and not torch.equal(got, want):
                raise AssertionError(f"{name}: groupmin_width(128) ({route}) differs from "
                                     + ("groupmin" if route == "mma" else "its own run"))
        rg, rs = GV.groupmin_two_level_ref(qf, x, nf32)
        for lay in layouts or GV.LAYOUTS:
            gm, sm = GV.groupmin_two_level(qf, x, nf32, lay)
            if not torch.equal(gm, want):
                raise AssertionError(f"{name}: two-level {lay} ({route}) group mins differ from "
                                     + ("groupmin's" if route == "mma" else "the row_dot sweep's"))
            errs[f"two_level_{lay}"] = max_abs_err(gm, rg)
            ulps = bf16_ulps(sm, rs)
            if ulps > 1.0:
                raise AssertionError(f"{name}: two-level {lay} ({route}) subgroup mins {ulps} "
                                     "bf16 ulps off")
            errs[f"two_level_{lay}_ulps"] = ulps
            per = 4
            pad = -sm.shape[1] % per
            smin4 = F.pad(sm.float(), (0, pad), value=float("inf")).view(sm.shape[0], -1,
                                                                          per).amin(2)
            if not torch.equal(gm.T.to(torch.bfloat16).float(), smin4):
                raise AssertionError(f"{name}: two-level {lay} ({route}) group mins are not "
                                     "their subgroups' min")
    for c in GV.CHUNKS if chunked else ():
        got = GV.groupmin_chunked(qf, x, norms, c)
        errs[f"chunk{c}"] = max_abs_err(got, GV.groupmin_chunked_ref(qf, x, norms))
    worst = max(v for k, v in errs.items() if not k.endswith("_ulps"))
    if worst > tol:
        raise AssertionError(f"{name}: prototype kernel error {worst} > tolerance {tol}")
    return errs


def edge_sweep_variants(gen) -> dict:
    """Every width, chunk and layout at N in {1, 31, 32, 33, 127, 129, 5000}
    x Q in {1, 7, 64}, d = 128 (and d = 130, rows of no 16-byte multiple,
    for the width and two-level kernels: 4-byte copies on tensor cores,
    scalar row loads on CUDA cores), and Q = 129 (a second, partial
    128-query tile) at N in {129, 5000}: query tiles of 16 (8 warps along a
    group's rows), 64 and 128 (4), and v2's staging. The width and
    two-level kernels on both routes (the chunked one once), untimed.
    Returns {"shapes", "mma", "cuda_core"}: the largest error per route."""
    import torch

    shapes = [(n, nq, d) for n in (1, 31, 32, 33, 127, 129, 5000) for nq in (1, 7, 64)
              for d in (128, 130)]
    shapes += [(n, 129, d) for n in (129, 5000) for d in (128, 130)]
    worst = {"mma": 0.0, "cuda_core": 0.0}
    for n, nq, d in shapes:
        x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
        q = torch.randn(nq, d, device="cuda", generator=gen).to(torch.bfloat16)
        nf32 = (torch.randn(n, d, device="cuda", generator=gen) ** 2).sum(1)
        norms = (x.float() ** 2).sum(1)
        for route in worst:
            errs = check_variants(f"variants edge N={n} Q={nq} d={d}", q, x, norms, nf32,
                                  route=route, chunked=route == "mma" and d % 8 == 0)
            worst[route] = max(worst[route], *(v for k, v in errs.items()
                                               if not k.endswith("_ulps")))
    log(f"  prototype edge sweep: {len(shapes)} shapes, every width, chunk and layout, both "
        f"routes; largest error {worst['mma']:.3g} (tensor cores; width 128 and two-level "
        f"group mins = groupmin bit for bit), {worst['cuda_core']:.3g} (CUDA cores)")
    return {"shapes": len(shapes), **worst}


def assert_ties_ascending(name, d, i) -> int:
    """Within each run of equal distances the ids ascend. Returns the
    number of tied neighbours seen."""
    d, i = np.asarray(d), np.asarray(i)
    eq = d[:, 1:] == d[:, :-1]
    if (eq & (i[:, 1:] <= i[:, :-1])).any():
        r, c = np.argwhere(eq & (i[:, 1:] <= i[:, :-1]))[0]
        raise AssertionError(f"{name}: tied ids out of order at query {r}: "
                             f"{i[r, c]}, {i[r, c + 1]}")
    return int(eq.sum())


def check_ties(gen) -> dict:
    """The flat paths over a store whose second half repeats its first (a
    corpus holding each image twice): ids equal to the plain full scan's
    (which sorts stably) except at near-ties of distinct rows, ties in
    ascending id order, and topk_merged equal to topk_twophase (check_merged:
    bit for bit where both score on CUDA cores, within tolerance where the
    two-phase search's Q = 16 f32 batch runs on tensor cores). FlatIndex f32
    and int8 (l2, ip), topk_twophase_safe, topk_merged, and k = 200 (the
    full-scan path)."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.parallel.topk import local_topk_with_norms

    half = torch.randn(TIE_HALF, TIE_D, device="cuda", generator=gen)
    x = torch.cat([half, half])
    q = torch.randn(TIE_Q, TIE_D, device="cuda", generator=gen)
    ties, checks = 0, 0
    for dtype in ("f32", "int8"):
        for metric in ("l2", "ip"):
            index = FlatIndex(metric, dtype=dtype, device="cuda").add(x)
            st = index.store
            tol = 2 * score_tol(q, st.norms)
            for k in (K, 200):
                name = f"ties {dtype} {metric} k={k}"
                d, i = index.search(q, k)
                rd, ri = local_topk_with_norms(q, st.vectors, st.norms, k, metric, scales=st.scales)
                assert_ids_equal(name, torch.as_tensor(i), ri.cpu(), rd.cpu(), tol)
                ties += assert_ties_ascending(name, d, i)
                checks += 1
    xs, norms = x, (x * x).sum(1)
    d, i = T.topk_twophase_safe(q, xs, K, "l2", x_norms=norms)
    rd, ri = local_topk_with_norms(q, xs, norms, K, "l2")
    assert_ids_equal("ties topk_twophase_safe", i, ri, rd, 2 * score_tol(q, norms))
    ties += assert_ties_ascending("ties topk_twophase_safe", d.cpu().numpy(), i.cpu().numpy())
    check_merged("ties topk_merged", q, xs, K, "l2", x_norms=norms, plain=False)
    checks += 2
    same = "bit for bit" if f32_route(xs, TIE_Q) == "cuda" else "within tolerance"
    log(f"  ties: {checks} searches over {2 * TIE_HALF:,} x {TIE_D} rows (second half = first "
        f"half), ids equal to the stable plain scan's, {ties} tied neighbours all in ascending "
        f"id order; topk_merged = topk_twophase {same}")
    return {"checks": checks, "tied_neighbours": ties}


def full_scan_sort_cost(gen, flush) -> dict:
    """The k > 128 path at N = 1M x 2048 f32, Q = 1, k = 200: the whole
    full scan, its stable sort of the 1M scores alone, and torch.topk's
    k smallest of the same scores (what the sort replaced); and the same two
    over the two-phase search's (1, t*128) candidates at k = 20."""
    import torch

    from image_search_engine_tpu_torch.ops.distances import stable_smallest
    from image_search_engine_tpu_torch.parallel.topk import local_topk_with_norms

    x = torch.randn(SORT_N, SORT_D, device="cuda", generator=gen)
    norms = (x * x).sum(1)
    q = torch.randn(1, SORT_D, device="cuda", generator=gen)
    s = norms[None, :] - 2.0 * (q @ x.T)
    cand = s[:, :(K + 4) * 128].contiguous()  # finish_candidates' (Q, t*128) at k = 20
    res = {"scan_ms": median_ms(lambda: local_topk_with_norms(q, x, norms, 200, "l2"), flush),
           "stable_sort_ms": median_ms(lambda: torch.sort(s, dim=1, stable=True), flush),
           "topk_ms": median_ms(lambda: torch.topk(s, 200, dim=1, largest=False), flush),
           "cand_sort_ms": median_ms(lambda: stable_smallest(cand, K), flush),
           "cand_topk_ms": median_ms(lambda: torch.topk(cand, K, dim=1, largest=False), flush)}
    log(f"  k > 128 full scan (N={SORT_N:,} d={SORT_D} f32, Q=1, k=200): {res['scan_ms']:.4f} "
        f"ms, of which the stable sort of the {SORT_N:,} scores {res['stable_sort_ms']:.4f} ms "
        f"(torch.topk {res['topk_ms']:.4f} ms); the two-phase search's final stable sort of (1, "
        f"{cand.shape[1]}) candidates {res['cand_sort_ms']:.4f} ms (torch.topk "
        f"{res['cand_topk_ms']:.4f} ms)")
    del x
    return res


def bench_store():
    """bench.py's data on the card (seed 0, 1M x 128, f32 rows and their
    bf16 store), built once for phases 6 and 7."""
    import torch

    from image_search_engine_tpu_torch.benchmarks import common

    t0 = time.perf_counter()
    store = common.make_store(BENCH_N, BENCH_D, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  store built in {time.perf_counter() - t0:.1f} s (seed 0, bench.py's data)")
    return store


def check_bench_kernels(name, qf, x, norms, t) -> tuple:
    """The bf16 tensor-core kernels at bench.py's point on the same tensors
    as their plain versions: groupmin and rescore within score_tol (512
    queries at a time, the plain version's (Q, N) scores), the select bit
    for bit, every candidate group's min equal to the min of its rescored
    rows bit for bit. Returns ({kernel: max_abs_err}, mins, vals, cand)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    mins = T.groupmin(qf, x, norms)
    vals, cand = T.select_topt(mins, t)
    scores = T.rescore(qf, x, norms, cand)
    errs = {"groupmin": 0.0, "rescore": 0.0}
    for s in range(0, qf.shape[0], 512):
        sl = slice(s, s + 512)
        errs["groupmin"] = max(errs["groupmin"],
                               max_abs_err(mins[sl], T.groupmin_ref(qf[sl], x, norms)))
        errs["rescore"] = max(errs["rescore"], max_abs_err(
            scores[sl], T.rescore_ref(qf[sl], x, norms, cand[sl])))
        rv, rids = T.select_topt_ref(mins[sl], t)
        if not (torch.equal(vals[sl].view(torch.int32), rv.view(torch.int32))
                and torch.equal(cand[sl], rids)):
            raise AssertionError(f"{name}: select differs from its plain version")
    if not torch.equal(scores.view(qf.shape[0], t, -1).amin(2), mins.gather(1, cand.long())):
        raise AssertionError(f"{name}: phase-1 group mins differ from phase-2 scores")
    tol = score_tol(qf, norms)
    for k, v in errs.items():
        if v > tol:
            raise AssertionError(f"{name}: {k} error {v} > tolerance {tol}")
    log(f"  {name}: groupmin err {errs['groupmin']:.3g}, rescore err {errs['rescore']:.3g} "
        f"(tol {tol:.3g}), select = plain, group mins = rescored rows' mins bit for bit")
    return errs, mins, vals, cand


def twin_breakdown(q, x, norms, flush) -> dict:
    """The bench twin's dispatch at Q = len(q), CUDA-event medians (L2
    flushed before each): the whole search (bench.search), then its steps
    as topk_twophase runs them: groupmin, select_topt, rescore and the
    finish (stable sort, ids, distances, certificate); the rest is the
    query's cast and the norms."""
    import torch

    from image_search_engine_tpu_torch import bench
    from image_search_engine_tpu_torch.ops import topk as T

    qf = q.to(x.dtype).contiguous()
    t = min(bench.K + bench.T_MARGIN, T.num_groups(x.shape[0]))
    mins = T.groupmin(qf, x, norms)
    vals, cand = T.select_topt(mins, t)
    scores = T.rescore(qf, x, norms, cand)
    ms = lambda fn: median_ms(fn, flush, reps=5)  # noqa: E731
    res = {"dispatch_ms": ms(lambda: bench.search(q, x, norms)),
           "groupmin_ms": ms(lambda: T.groupmin(qf, x, norms)),
           "select_topt_ms": ms(lambda: T.select_topt(mins, t)),
           "rescore_ms": ms(lambda: T.rescore(qf, x, norms, cand)),
           "finish_ms": ms(lambda: T.finish_candidates(q, scores, cand, vals[:, t - 1], bench.K,
                                                       "l2", True)),
           "select_library_ms": ms(lambda: torch.topk(mins, t, dim=1, largest=False)),
           "select": time_select("bench point", mins, t, flush)}
    res["other_ms"] = res["dispatch_ms"] - sum(res[k] for k in (
        "groupmin_ms", "select_topt_ms", "rescore_ms", "finish_ms"))
    return res


def phase6(store) -> dict:
    """bench.py's operating point: the main path (bench twin, then each
    ported script's searches once; launch counts set to 0 just before, read
    just after, the prototypes' by route, none on CUDA cores), each script's
    searches timed beside the shipped one, then the bf16 tensor-core
    kernels against their plain versions at Q = 2048 and 4096, the twin's
    dispatch split into its steps, the four prototype kernels checked (the
    width and two-level ones on both routes) and timed beside ``groupmin``
    and the product alone, the edge sweep, the tie check and the full
    scan's sort."""
    import torch

    from image_search_engine_tpu_torch import bench
    from image_search_engine_tpu_torch.benchmarks import common
    from image_search_engine_tpu_torch.benchmarks import rescore_variants2 as RV2
    from image_search_engine_tpu_torch.benchmarks import subgroup_proto as SP
    from image_search_engine_tpu_torch.benchmarks import subgroup_variants as SV
    from image_search_engine_tpu_torch.benchmarks import sweep_chunked as SC
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import topk as T

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    nbf, nf32 = store.norms_bf16_rows(), store.norms_f32_rows()

    def recall_of(fn, q):
        return common.recall(fn(q)[1][:8], common.float64_topk_ids(q[:8], store.x32, BENCH_K))

    q2048 = common.queries(store, 1, PROTO_Q)[0]
    q4096 = common.queries(store, 1, BENCH_Q)[0]
    # each script's searches: (name, fn, queries)
    runs = {"rescore_variants2": [(name, fn, q2048) for name, fn in RV2.searches(store.x, nf32)],
            "subgroup_proto": [(f"{name} Q={q.shape[0]}", fn, q) for q in (q2048, q4096)
                               for name, fn in SP.searches(store.x, nf32)],
            "subgroup_variants": [(name, fn, q2048) for name, fn in SV.searches(store.x, nf32)]}
    torch.cuda.synchronize()
    T.reset_launch_counts()
    out = bench.run(store, BENCH_Q, BENCH_ITERS)
    print(json.dumps(out), flush=True)
    GV.reset_launch_counts()  # the prototypes' counts, by route, over the scripts' searches
    sums = {name: float(fn(q2048)) for name, fn in SC.sweeps(store.x, nbf)}
    recalls, two_level_mma = {}, {}
    for script, rs in runs.items():
        before = GV.groupmin_two_level.mma_launches
        recalls[script] = {name: recall_of(fn, q) for name, fn, q in rs}
        torch.cuda.synchronize()
        two_level_mma[script] = GV.groupmin_two_level.mma_launches - before
    launches = {"groupmin_width": GV.groupmin_width.mma_launches,
                "groupmin_chunked": GV.groupmin_chunked.launches,
                "groupmin_two_level": two_level_mma["subgroup_proto"],
                "groupmin_two_level_layouts": two_level_mma["subgroup_variants"],
                "groupmin": T.groupmin.launches, "select_topt": T.select_topt.launches,
                "rescore": T.rescore.launches}
    by_route = {fn.__name__: {r: getattr(fn, f"{r}_launches") for r in GV.ROUTES}
                for fn in (GV.groupmin_width, GV.groupmin_two_level)}
    note_extract_min("bench twin and scripts")
    if not all(launches.values()):
        raise AssertionError(f"phase 6 main path: a kernel did not launch: {launches}")
    if any(r["cuda_core"] for r in by_route.values()):
        raise AssertionError(f"phase 6 main path: the CUDA-core prototype route ran: {by_route}")
    ref_sum = sums["current"]
    for name, v in sums.items():
        if not abs(v - ref_sum) < abs(ref_sum) * 1e-6 + 1.0:
            raise AssertionError(f"sweep_chunked {name}: sum of mins {v} vs current {ref_sum}")
    if out["exactness_certified_frac"] != 1.0 or out["recall_at_10_vs_float64"] < 0.95:
        raise AssertionError(f"bench twin: {out}")
    for script, r in recalls.items():
        if min(r.values()) < 0.9:
            raise AssertionError(f"{script}: recall@10 {r}")
        log(f"  {script} recall@10 vs float64 (8 queries): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r.items()))
    log(f"  main path: bench twin {out['value']} QPS (Q={BENCH_Q}, {BENCH_ITERS} dispatches), "
        f"recall@10 {out['recall_at_10_vs_float64']:.5f}, certified "
        f"{out['exactness_certified_frac']}; sweep_chunked sums agree; launches {launches}; "
        f"prototype launches by route {by_route}")
    # each script's searches timed (ms per dispatch), the shipped search among them
    search_ms = {}
    for script, rs in runs.items():
        search_ms[script] = {name: median_ms(lambda: fn(q), flush, reps=SEARCH_REPS)
                             for name, fn, q in rs}
        log(f"  {script} ms per dispatch: " + ", ".join(
            f"{k} {v:.4f}" for k, v in search_ms[script].items()))

    # the bf16 tensor-core kernels against their plain versions, the twin's dispatch in steps
    qf = q2048.to(torch.bfloat16).contiguous()
    qf4 = q4096.to(torch.bfloat16).contiguous()
    t = min(BENCH_K + 2, T.num_groups(BENCH_N))
    mma_errs = {}
    for nq, qq in ((PROTO_Q, qf), (BENCH_Q, qf4)):
        errs_q, *_ = check_bench_kernels(f"bf16 kernels Q={nq} t={t} (bf16-row norms)", qq,
                                         store.x, nbf, t)
        mma_errs.update({f"{k}_Q{nq}": v for k, v in errs_q.items()})
    split = twin_breakdown(q4096, store.x, nbf, flush)
    log(f"  bench twin dispatch at Q={BENCH_Q}: {split['dispatch_ms']:.4f} ms = groupmin "
        f"{split['groupmin_ms']:.4f} + select_topt {split['select_topt_ms']:.4f} (torch.topk "
        f"{split['select_library_ms']:.4f}) + rescore {split['rescore_ms']:.4f} + finish "
        f"{split['finish_ms']:.4f} + other {split['other_ms']:.4f} ms; twin {out['value']} QPS, "
        f"recall@10 {out['recall_at_10_vs_float64']:.5f}, certified "
        f"{out['exactness_certified_frac']}")

    # the four prototype kernels against their plain versions (width and
    # two-level on both routes), then timed
    regs = bench_point_registers()
    log(f"  registers a thread at the bench point's tiles (two 256-thread blocks an SM take at "
        f"most 128): {regs}")
    errs = check_variants("Q=2048", qf, store.x, nbf, nf32)
    errs4 = check_variants("Q=4096", qf4, store.x, nbf, nf32, chunked=False)
    cc_errs = check_variants("Q=2048 CUDA cores", qf, store.x, nbf, nf32, route="cuda_core",
                             chunked=False)
    cc_errs4 = check_variants("Q=4096 CUDA cores", qf4, store.x, nbf, nf32, route="cuda_core",
                              layouts=("v1",), widths=(), chunked=False)
    edge = edge_sweep_variants(gen)
    n, d = BENCH_N, BENCH_D
    ng, nsub = T.num_groups(n), -(-n // GV.SUB)

    def bnd(nq, out_bytes):
        return bound(n * d * 2 + n * 4 + nq * d * 2 + out_bytes, 2 * nq * n * d, BF16_FLOPS)

    x = store.x

    def proto_times(route: str, reps: int) -> dict:
        """The width and two-level kernels on ``route`` at Q = 2048 (v1 also
        at 4096), CUDA-event medians after an L2 flush."""
        res = {}
        with variants_route(route):
            for g in GV.WIDTHS:
                res[f"width{g}"] = median_ms(lambda: GV.groupmin_width(qf, x, nf32, g), flush,
                                             reps=reps)
            for lay in GV.LAYOUTS:
                res[f"two_level_{lay}"] = median_ms(
                    lambda: GV.groupmin_two_level(qf, x, nf32, lay), flush, reps=reps)
            res["two_level_v1_Q4096"] = median_ms(
                lambda: GV.groupmin_two_level(qf4, x, nf32, "v1"), flush, reps=reps)
        return res

    ms = lambda fn: median_ms(fn, flush, reps=PROTO_REPS)  # noqa: E731
    times = {"groupmin": ms(lambda: T.groupmin(qf, x, nf32)),
             "product": ms(lambda: torch.matmul(qf, x.T)),
             "groupmin_Q4096": ms(lambda: T.groupmin(qf4, x, nf32)),
             "product_Q4096": ms(lambda: torch.matmul(qf4, x.T)),
             **proto_times("mma", PROTO_REPS)}
    sub_major = torch.empty((nsub, PROTO_Q), dtype=torch.bfloat16, device="cuda")
    times["v3_transpose"] = ms(lambda: sub_major.T.contiguous())  # v3's wrapper, alone
    for c in GV.CHUNKS:
        times[f"chunk{c}"] = ms(lambda: GV.groupmin_chunked(qf, x, nbf, c))
    cuda_core = proto_times("cuda_core", CUDA_CORE_REPS)
    plain = {"groupmin": median_ms(lambda: T.groupmin_ref(qf, x, nf32), flush, reps=2),
             "width": median_ms(lambda: GV.groupmin_width_ref(qf, x, nf32, 128), flush, reps=2),
             "two_level": median_ms(lambda: GV.groupmin_two_level_ref(qf, x, nf32), flush, reps=2),
             "chunked": median_ms(lambda: GV.groupmin_chunked_ref(qf, x, nbf), flush, reps=2)}
    log(f"  groupmin (tensor cores) at Q={PROTO_Q}: {times['groupmin']:.4f} ms (Q={BENCH_Q} "
        f"{times['groupmin_Q4096']:.4f}; plain {plain['groupmin']:.4f}), the bf16 product alone "
        f"{times['product']:.4f} ms "
        f"(Q={BENCH_Q} {times['product_Q4096']:.4f}), the row_dot sweep (groupmin_width 128 on "
        f"CUDA cores) {cuda_core['width128']:.4f} ms; distance from the row_dot sweep's mins "
        f"{cc_errs['groupmin_vs_row_dot']:.3g}")
    log(f"  prototype kernels at Q={PROTO_Q} (N={n:,} d={d} bf16), tensor cores: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()) + "; CUDA cores (replaced): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in cuda_core.items()) + "; plain " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in plain.items()) + "; errors " + "; ".join(
        f"{k} {v:.3g}" for k, v in {**errs, **{f"{k} Q=4096": v for k, v in errs4.items()},
                                    **{f"{k} CUDA cores": v for k, v in cc_errs.items()},
                                    **{f"{k} CUDA cores Q=4096": v
                                       for k, v in cc_errs4.items()}}.items()))
    tie = check_ties(gen)
    del store, nbf, nf32, x, qf, qf4, sub_major
    torch.cuda.empty_cache()
    sort = full_scan_sort_cost(gen, flush)

    def worst(prefix):
        return max(edge["mma"], *(v for e in (errs, errs4) for k, v in e.items()
                                  if k.startswith(prefix) and not k.endswith("_ulps")))

    def worst_cuda_core(prefix):
        return max(edge["cuda_core"], *(v for e in (cc_errs, cc_errs4) for k, v in e.items()
                                        if k.startswith(prefix) and not k.endswith("_ulps")))

    b2048 = {"groupmin_width": bnd(PROTO_Q, -(-n // 32) * PROTO_Q * 4),
             "groupmin_chunked": bnd(PROTO_Q, ng * PROTO_Q * 4),
             "groupmin_two_level": bnd(PROTO_Q, ng * PROTO_Q * 4 + nsub * PROTO_Q * 2)}
    width_ms = {f"G={g}_ms": times[f"width{g}"] for g in GV.WIDTHS}
    layout_ms = {f"{lay}_ms": times[f"two_level_{lay}"] for lay in GV.LAYOUTS}
    entries = [
        ("groupmin_width", times["width32"], plain["width"], b2048["groupmin_width"],
         worst("width"), "Q=2048 N=1,000,000 d=128 bf16 G=32 (f32-row norms)",
         {**width_ms, "cuda_core": {
             "source": SOURCE_VARIANTS_CUDA_CORE, "max_abs_err": worst_cuda_core("width"),
             **{f"G={g}_ms": cuda_core[f"width{g}"] for g in GV.WIDTHS}}}),
        ("groupmin_chunked", times["chunk512"], plain["chunked"], b2048["groupmin_chunked"],
         worst("chunk"), "Q=2048 N=1,000,000 d=128 bf16 chunk=512 (bf16-row norms)",
         {f"chunk={c}_ms": times[f"chunk{c}"] for c in GV.CHUNKS}),
        ("groupmin_two_level", times["two_level_v1"], plain["two_level"],
         b2048["groupmin_two_level"], worst("two_level_v1"),
         "Q=2048 N=1,000,000 d=128 bf16 v1 (f32-row norms)",
         {"Q=4096_ms": times["two_level_v1_Q4096"],
          "Q=4096_bound_ms": bnd(BENCH_Q, ng * BENCH_Q * 4 + nsub * BENCH_Q * 2)[0],
          "cuda_core": {"source": SOURCE_VARIANTS_CUDA_CORE,
                        "max_abs_err": worst_cuda_core("two_level_v1"),
                        "v1_ms": cuda_core["two_level_v1"],
                        "Q=4096_ms": cuda_core["two_level_v1_Q4096"]}}),
        ("groupmin_two_level_layouts", times["two_level_v3"], plain["two_level"],
         b2048["groupmin_two_level"], worst("two_level"),
         "Q=2048 N=1,000,000 d=128 bf16 v3 (f32-row norms)",
         {**layout_ms, "v3_transpose_ms": times["v3_transpose"], "cuda_core": {
             "source": SOURCE_VARIANTS_CUDA_CORE, "max_abs_err": worst_cuda_core("two_level"),
             **{f"{lay}_ms": cuda_core[f"two_level_{lay}"] for lay in GV.LAYOUTS}}}),
    ]
    # the kernels line's names of the tensor-core prototypes: (wrapper, registers' key prefix)
    on_sweep = {"groupmin_width": ("groupmin_width", "width"),
                "groupmin_two_level": ("groupmin_two_level", "two_level"),
                "groupmin_two_level_layouts": ("groupmin_two_level", "two_level")}
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": err, "ms": tk, "plain_ms": p, "bound_ms": b[0],
        "bound_by": b[1], "library_ms": None, "shape": shape,
        **({"launches_by_route": by_route[on_sweep[name][0]],
            "registers_bench_point": {k: v for k, v in regs.items()
                                      if k.startswith(on_sweep[name][1])}}
           if name in on_sweep else {}),
        "product_alone_ms": times["product"], "groupmin_ms": times["groupmin"], "variants": extra,
    } for name, tk, p, b, err, shape, extra in entries]
    b2048, b4096 = bnd(PROTO_Q, ng * PROTO_Q * 4), bnd(BENCH_Q, ng * BENCH_Q * 4)
    worst_groupmin = max(v for k, v in mma_errs.items() if k.startswith("groupmin"))
    bf16 = {
        "groupmin": {
            "launches": launches["groupmin"], "max_abs_err": worst_groupmin,
            "ms": times["groupmin"], "plain_ms": plain["groupmin"], "bound_ms": b2048[0],
            "bound_by": b2048[1], "shape": f"Q={PROTO_Q} N={n:,} d={d} bf16 (bench.py's point)",
            "Q4096_ms": times["groupmin_Q4096"], "Q4096_bound_ms": b4096[0],
            "product_alone_ms": times["product"], "product_alone_Q4096_ms": times["product_Q4096"],
            "row_dot_sweep_ms": cuda_core["width128"]},
        "rescore": {"launches": launches["rescore"],
                    "max_abs_err": max(v for k, v in mma_errs.items() if k.startswith("rescore")),
                    "Q4096_t12_ms": split["rescore_ms"]},
    }
    return {"bench": out, "kernels": kernels, "times": times, "cuda_core_times": cuda_core,
            "search_ms": search_ms, "ties": tie, "sort": sort, "bf16": bf16,
            "twin_split": split}


# ---------------------------------------------------------------------------
# Phase 7: bench.py's operating point, phase 2's prototypes (rescore variants)
# ---------------------------------------------------------------------------

RESCORE_MARGIN = 2  # the phase-2 prototypes' margin: t = k + 2 = 12 candidate groups


def check_rescore_variants(name, qf, x, norms, cand, tol, *, qbs=None, cross=True) -> dict:
    """rescore_gather at each QB (and rescore_cross) against their plain
    versions on (qf, x, cand): scores within tol, +inf (cross: 0) exactly at
    the rows past N, and the final top-10 of the kernel's scores the plain
    scores' (near-ties apart; the cross products scored as the script's
    epilogue does, ``norms`` with PAD_NORM past N). Returns {kernel_qb:
    max_abs_err}."""
    import torch

    from image_search_engine_tpu_torch.ops import rescore_variants as RV
    from image_search_engine_tpu_torch.ops.distances import stable_smallest
    from image_search_engine_tpu_torch.ops.topk import _candidate_rows
    from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

    valid, safe = _candidate_rows(cand, x.shape[0])
    cn = torch.where(valid, norms[safe], torch.full_like(valid, PAD_NORM, dtype=torch.float32))
    kk = min(BENCH_K, valid.shape[1])
    errs = {}
    kinds = [("gather", RV.rescore_gather, RV.rescore_gather_ref, float("inf"))]
    if cross:
        kinds.append(("cross", RV.rescore_cross, RV.rescore_cross_ref, 0.0))
    for kind, fn, ref, past in kinds:
        want = ref(qf, x, cand)
        final = (lambda s: s) if kind == "gather" else (lambda s: cn - 2.0 * s)
        rd, rpos = stable_smallest(final(want), kk)
        for qb in qbs or RV.QBS:
            got = fn(qf, x, cand, qb=qb)
            if not bool((got[~valid] == past).all()):
                raise AssertionError(f"{name}: rescore_{kind} qb={qb} rows past N are not {past}")
            errs[f"{kind}_qb{qb}"] = max_abs_err(got, want)
            _, pos = stable_smallest(final(got), kk)
            assert_ids_equal(f"{name} rescore_{kind} qb={qb}", pos, rpos, rd, tol)
    worst = max(errs.values())
    if worst > tol:
        raise AssertionError(f"{name}: rescore variant error {worst} > tolerance {tol}")
    return errs


def edge_sweep_rescore(gen) -> float:
    """Both kernels at every QB over N in {1, 127, 128, 129, 5000}, Q in {1,
    7, 33}, d in {128, 130} (rows of no 16-byte multiple: scalar loads) and
    t in {1, 12} (at most ngroups), random candidate groups with the ragged
    last group among them, untimed. Returns the largest error."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    worst, cases = 0.0, 0
    for n in (1, 127, 128, 129, 5000):
        ng = T.num_groups(n)
        for nq in (1, 7, 33):
            for d in (128, 130):
                x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
                q = torch.randn(nq, d, device="cuda", generator=gen).to(torch.bfloat16)
                norms = (x.float() ** 2).sum(1)
                for t in sorted({min(t, ng) for t in (1, 12)}):
                    cand = torch.randint(0, ng, (nq, t), device="cuda", generator=gen,
                                         dtype=torch.int32)
                    cand[:, 0] = ng - 1
                    errs = check_rescore_variants(f"rescore edge N={n} Q={nq} d={d} t={t}", q, x,
                                                  norms, cand, score_tol(q, norms))
                    worst = max(worst, *errs.values())
                    cases += 1
    log(f"  rescore variants edge sweep: {cases} shapes, both kernels at every QB; largest error "
        f"{worst:.3g}")
    return worst


def rescore_bound(nq, x, cand, ops_per_element, norms_bytes=0):
    """bound() of a phase-2 rescore: the distinct candidate groups' rows
    inside the store (each read once), their norms where the kernel reads
    them, the bf16 query, the candidate ids and the (Q, t*128) f32 output;
    ``ops_per_element`` products per gathered element, at the bf16 peak."""
    import torch

    from image_search_engine_tpu_torch.ops.topk import GROUP

    n, d = x.shape
    groups = torch.unique(cand).long()
    rows = int(torch.clamp(n - groups * GROUP, 0, GROUP).sum().item())
    t = cand.shape[1]
    moved = rows * (d * 2 + norms_bytes) + nq * d * 2 + nq * t * 4 + nq * t * GROUP * 4
    return bound(moved, ops_per_element * nq * t * GROUP * d, BF16_FLOPS), len(groups)


def phase7(store) -> dict:
    """bench.py's operating point, phase 2's prototypes: the main path (each
    ported script's searches once, launch counts set to 0 just before, read
    just after; rescore_gather's launches inside gather_kernel_sweep2 count
    for its row), then the kernels against their plain versions at Q = 2048
    and 4096 on a real phase 1's candidates, the edge sweep, and the
    timings beside the production rescore."""
    import torch

    from image_search_engine_tpu_torch.benchmarks import common
    from image_search_engine_tpu_torch.benchmarks import gather_kernel_proto as GP
    from image_search_engine_tpu_torch.benchmarks import gather_kernel_sweep as GS
    from image_search_engine_tpu_torch.benchmarks import gather_kernel_sweep2 as GS2
    from image_search_engine_tpu_torch.benchmarks import hier_select as HS
    from image_search_engine_tpu_torch.benchmarks import rescore_dma_variants as RD
    from image_search_engine_tpu_torch.ops import rescore_variants as RV
    from image_search_engine_tpu_torch.ops import topk as T

    log("phase 7: bench.py's operating point, the phase-2 prototypes (fused gather and rescore, "
        "cross products only, hierarchical select)")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    x, nbf = store.x, store.norms_bf16_rows()
    queries = {nq: common.queries(store, 1, nq)[0] for nq in (PROTO_Q, BENCH_Q)}
    ref = {nq: common.float64_topk_ids(q[:8], store.x32, BENCH_K) for nq, q in queries.items()}

    recalls, covers = {}, {}

    def run(script, runs, nq):
        for name, fn in runs:
            ids = fn(queries[nq])[1]
            recalls.setdefault(script, {})[f"{name} Q={nq}"] = common.recall(ids[:8], ref[nq])

    T.reset_launch_counts()
    RV.reset_launch_counts()
    run("gather_kernel_proto", GP.searches(x, nbf), PROTO_Q)
    run("gather_kernel_sweep", GS.searches(x, nbf), PROTO_Q)
    run("rescore_dma_variants", RD.searches(x, nbf), PROTO_Q)
    run("hier_select", HS.searches(x, nbf), PROTO_Q)
    name, fn = GS.phase1(x, nbf)
    covers[name] = common.group_recall(fn(queries[PROTO_Q])[1][:8], ref[PROTO_Q], T.GROUP)
    torch.cuda.synchronize()
    before = RV.rescore_gather.launches
    sweep2 = GS2.searches(x, nbf)
    run("gather_kernel_sweep2", sweep2, PROTO_Q)
    run("gather_kernel_sweep2", sweep2[-1:], BENCH_Q)  # the exact search at Q = 4096
    parts = dict(GS2.partials(x, nbf))
    for name in ("sweep+select(exact)", "sweep+select(approx .95)"):
        covers[name] = common.group_recall(parts[name](queries[PROTO_Q])[1][:8], ref[PROTO_Q],
                                           T.GROUP)
    sweep_sum = parts["sweep-only"](queries[PROTO_Q])[0]
    torch.cuda.synchronize()
    launches = {"rescore_gather": before,
                "rescore_gather_sweep2": RV.rescore_gather.launches - before,
                "rescore_cross": RV.rescore_cross.launches, "groupmin": T.groupmin.launches,
                "rescore": T.rescore.launches}
    if not all(launches.values()):
        raise AssertionError(f"phase 7 main path: a kernel did not launch: {launches}")
    qf = queries[PROTO_Q].to(torch.bfloat16).contiguous()
    if not torch.equal(sweep_sum, T.groupmin(qf, x, nbf).sum()[None, None]):
        raise AssertionError("gather_kernel_sweep2 sweep-only: sum differs from groupmin's")
    for script, r in recalls.items():
        low = {k: v for k, v in r.items() if v < (0.9 if "approx" in k else 0.95)}
        if low:
            raise AssertionError(f"{script}: recall@10 {low}")
        log(f"  {script} recall@10 vs float64 (8 queries): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r.items()))
    log("  true top-10 inside the candidate groups (8 queries): " + ", ".join(
        f"{k} {v:.3f}" for k, v in covers.items()) + f"; launches {launches}")

    # the kernels against their plain versions on a real phase 1's candidates, then timed
    cand = GP.candidates(qf, x, nbf, RESCORE_MARGIN)
    qf4 = queries[BENCH_Q].to(torch.bfloat16).contiguous()
    cand4 = GP.candidates(qf4, x, nbf, RESCORE_MARGIN)
    errs = check_rescore_variants(f"Q={PROTO_Q}", qf, x, nbf, cand, score_tol(qf, nbf))
    errs4 = check_rescore_variants(f"Q={BENCH_Q}", qf4, x, nbf, cand4, score_tol(qf4, nbf),
                                   qbs=(8,), cross=False)
    worst_edge = edge_sweep_rescore(gen)
    ms = lambda fn: median_ms(fn, flush)  # noqa: E731
    times, plain = {}, {}
    for qb in RV.QBS:
        times[f"gather_qb{qb}"] = ms(lambda: RV.rescore_gather(qf, x, cand, qb=qb))
        times[f"cross_qb{qb}"] = ms(lambda: RV.rescore_cross(qf, x, cand, qb=qb))
    times["gather_qb8_Q4096"] = ms(lambda: RV.rescore_gather(qf4, x, cand4))
    times["rescore"] = ms(lambda: T.rescore(qf, x, nbf, cand))
    plain["gather"] = ms(lambda: RV.rescore_gather_ref(qf, x, cand))
    plain["gather_Q4096"] = ms(lambda: RV.rescore_gather_ref(qf4, x, cand4))
    plain["cross"] = ms(lambda: RV.rescore_cross_ref(qf, x, cand))
    plain["rescore"] = ms(lambda: T.rescore_ref(qf, x, nbf, cand))
    b_gather, ngroups = rescore_bound(PROTO_Q, x, cand, 4)
    b_gather4, ngroups4 = rescore_bound(BENCH_Q, x, cand4, 4)
    b_cross, _ = rescore_bound(PROTO_Q, x, cand, 2)
    b_rescore, _ = rescore_bound(PROTO_Q, x, cand, 2, norms_bytes=4)
    t = cand.shape[1]
    log(f"  rescore variants at Q={PROTO_Q} t={t} ({ngroups:,} distinct groups of "
        f"{PROTO_Q * t:,} picks; Q={BENCH_Q}: {ngroups4:,} of {BENCH_Q * t:,}): " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()) + "; plain " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in plain.items()) + f"; bounds gather {b_gather[0]:.4f}, "
        f"cross {b_cross[0]:.4f}, rescore {b_rescore[0]:.4f}, gather Q={BENCH_Q} "
        f"{b_gather4[0]:.4f} ms; errors " + "; ".join(
            f"{k} {v:.3g}" for k, v in {**errs, **{f"{k} Q={BENCH_Q}": v
                                                   for k, v in errs4.items()}}.items())
        + f"; phase 7 took {time.perf_counter() - t0:.1f} s")

    def worst(kind):
        return max(worst_edge, *(v for e in (errs, errs4) for k, v in e.items()
                                 if k.startswith(kind)))

    shape = f"Q={PROTO_Q} t={t} N={BENCH_N:,} d={BENCH_D} bf16 QB=8 (a real phase 1's candidates)"
    production = {"production_rescore_ms": times["rescore"],
                  "production_rescore_plain_ms": plain["rescore"],
                  "production_rescore_bound_ms": b_rescore[0], "distinct_groups": ngroups}
    rescore_bf16 = {"ms": times["rescore"], "plain_ms": plain["rescore"], "bound_ms": b_rescore[0],
                    "bound_by": b_rescore[1],
                    "shape": f"Q={PROTO_Q} t={t} N={BENCH_N:,} d={BENCH_D} bf16 (a real phase 1's "
                             "candidates)"}
    entries = [
        ("rescore_gather", times["gather_qb8"], plain["gather"], b_gather, worst("gather"),
         {f"QB={qb}_ms": times[f"gather_qb{qb}"] for qb in RV.QBS}),
        ("rescore_gather_sweep2", times["gather_qb8"], plain["gather"], b_gather, worst("gather"),
         {"Q=4096_ms": times["gather_qb8_Q4096"], "Q=4096_plain_ms": plain["gather_Q4096"],
          "Q=4096_bound_ms": b_gather4[0], "Q=4096_distinct_groups": ngroups4}),
        ("rescore_cross", times["cross_qb8"], plain["cross"], b_cross, worst("cross"),
         {f"QB={qb}_ms": times[f"cross_qb{qb}"] for qb in RV.QBS}),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": err, "ms": tk, "plain_ms": p, "bound_ms": b[0],
        "bound_by": b[1], "library_ms": None, "shape": shape, **production, "variants": extra,
    } for name, tk, p, b, err, extra in entries]
    return {"kernels": kernels, "times": times, "recalls": recalls, "rescore_bf16": rescore_bf16}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from image_search_engine_tpu_torch.ops import _kernels
    from image_search_engine_tpu_torch.ops import topk as T

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    log(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} ({card})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path, secs = _kernels.build()
    _kernels.library()
    ptx = path.with_suffix(".log").read_text()
    regs = re.findall(r"Used (\d+) registers", ptx)
    spills = re.findall(r"(\d+) bytes spill stores", ptx)
    log(f"  kernels built in {secs:.1f} s -> {path.name}; {len(regs)} instantiations, "
        f"registers {min(map(int, regs))}-{max(map(int, regs))}, "
        f"max spill stores {max(map(int, spills))} bytes")

    shapes, mma_edge, sel_sweep = phase1()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        served = phase2(workdir)
        scale = phase3_scale()
        pq_served = phase3_entry(workdir, served["paths"])
        batched = phase3_batched()
        shapes_q8 = phase4_kernels()
        q8_served = phase4_entry(workdir, served["paths"], served["art"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    last = phase5()
    log(f"phase 6: bench.py's operating point ({BENCH_N:,} x {BENCH_D} bf16 store, k = {BENCH_K})")
    store = bench_store()
    sixth = phase6(store)
    seventh = phase7(store)
    log("phase 4 (continued): groupmin_q8 at bench.py's point")
    bench_q8 = bench_point_q8(store, torch.empty(32 << 20, dtype=torch.float32, device="cuda"))
    del store

    head = shapes["Q1_N1M_d2048_f32_l2"]
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": served["launches"][name],
        "max_abs_err": max(s[name]["max_abs_err"] for s in shapes.values()),
        "ms": head[name]["ms"], "plain_ms": head[name]["plain_ms"],
        "bound_ms": head[name]["bound_ms"], "bound_by": head[name]["bound_by"],
        "library_ms": head[name]["library_ms"],
        "shape": "Q=1 N=1,000,000 d=2048 f32 l2 k=20",
    } for name in ("groupmin", "select_topt", "rescore")]
    # the select: the radix route at each shape the main paths give it and
    # beyond t = 256 (k = 300 and a rerank shortlist of 1000 over IVF-PQ),
    # the extract-min kernel it replaced timed beside it; the sweep
    sel = kernels[1]
    for k in ("device_ms", "extract_min_ms", "extract_min_device_ms"):
        sel[k] = head["select_topt"][k]
    sel["radix_route_launches"] = served["select_radix_launches"]
    sel["rank_max_t"], sel["shared_sort_max_t"] = T.SELECT_RANK_MAX_T, T.SELECT_SHARED_SORT_MAX_T
    sel["served_index_Q1"] = served["select"]
    sel["Q64_N1M_d2048"] = {k: v for k, v in shapes["Q64_N1M_d2048_f32_l2"]["select_topt"].items()
                            if k != "max_abs_err"}
    sel["ivf_probed"] = {f"Q{nq}": scale["scan"][nq]["select"] for nq in (1, 64)}
    sel["bench_point"] = sixth["twin_split"]["select"]
    sel["beyond_256"] = {"ivfpq_launches": scale["beyond_256_launches"], **sel_sweep["big_t"]}
    sel["extract_min_comparison"] = {"source": SOURCE_SELECT_EXTRACT_MIN,
                                     "main_path_launches": sum(MAIN_PATH_EXTRACT_MIN.values()),
                                     "main_path_runs": MAIN_PATH_EXTRACT_MIN,
                                     "shapes_bit_equal": sel_sweep["extract_min_compared"]}
    sel["sweep"] = {"shapes": sel_sweep["shapes"], "launches": sel_sweep["launches"],
                    "radix_Q1_W7813_t24": sel_sweep["routes"]["radix_Q1"],
                    "radix_Q4096_W7813_t24": sel_sweep["routes"]["radix_Q4096"]}
    # the f32 sweep beside cuBLAS's f32 product alone at Q = 1; both f32
    # sweeps by batch size; Q = 64 on tensor cores (3xTF32) and on CUDA cores
    kernels[0]["product_alone_ms"] = head["groupmin"]["product_alone_ms"]
    kernels[0]["f32_ms_by_batch"] = {f"Q={q}": {"cuda_cores" if r == "cuda" else "tensor_cores": v
                                                for r, v in rt.items()}
                                     for q, rt in head["routes"].items()}
    f32q64, f32q256 = shapes["Q64_N1M_d2048_f32_l2"], shapes["Q256_N1M_d2048_f32_l2"]
    for entry in kernels:
        name = entry["name"]
        if name not in ("groupmin", "rescore"):
            continue
        r = f32q64[name]
        tc = {"route": "tensor cores, 3xTF32", "from_q": T.F32_CUDA_CORE_MAX_Q + 1,
              "source": SOURCES_F32_TC[name], "shape": "Q=64 N=1,000,000 d=2048 f32 l2 k=20",
              "launches": served["batch"][name],
              "max_abs_err": max(r["max_abs_err"], f32q256[name]["max_abs_err"],
                                 mma_edge["f32"]),
              **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
              "search_ms": f32q64["search_ms"],
              "cuda_core_route": {**f32q64["cuda_cores"][name],
                                  "search_ms": f32q64["cuda_cores"]["search_ms"]},
              "Q256": {**{k: f32q256[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                       "search_ms": f32q256["search_ms"],
                       "cuda_core_ms": f32q256["cuda_cores"][name]["ms"],
                       "cuda_core_search_ms": f32q256["cuda_cores"]["search_ms"]}}
        if name == "groupmin":
            tc["product_alone_ms"] = r["product_alone_ms"]
            tc["Q256"]["product_alone_ms"] = f32q256[name]["product_alone_ms"]
        entry["f32_tensor_cores"] = tc
        entry["f32_cuda_cores_up_to_q"] = T.F32_CUDA_CORE_MAX_Q
    # the bf16 store's kernels (tensor cores): bench.py's point, then 1M x 2048
    corpus = {f"N1M_d2048_Q{nq}": shapes[f"Q{nq}_N1M_d2048_bf16_l2"] for nq in (1, 64)}
    for entry in kernels:
        name = entry["name"]
        if name not in ("groupmin", "rescore"):
            continue
        bf16 = dict(sixth["bf16"][name])
        if name == "rescore":
            bf16.update(seventh["rescore_bf16"])
        bf16["max_abs_err"] = max(bf16["max_abs_err"], mma_edge["bf16"],
                                  *(c[name]["max_abs_err"] for c in corpus.values()))
        for c, r in corpus.items():
            bf16[c] = {k: v for k, v in r[name].items() if k != "max_abs_err"}
        entry["bf16"] = bf16
    scan, asg = scale["scan"], scale["assign"]
    scan1 = scan[1]
    kernels.append({
        "name": "probed_scan", "route": "cuda", "source": SOURCES["probed_scan"],
        "replaces": REPLACES["probed_scan"], "launches": pq_served["launches"]["probed_scan"],
        "launches_by_route": {
            "serving": {r: pq_served["launches"][f"probed_scan_{r}"] for r in ("slot", "bucket")},
            "batched_search_batched": {f"{dt}_Q{nq}": b["Q"][nq]["search_launches"]
                                       for dt, b in batched.items() for nq in BATCHED_Q}},
        "max_abs_err": max(scan["max_abs_err"], *(r["max_abs_err"] for b in batched.values()
                                                  for r in b["Q"].values())),
        **{k: scan1[k] for k in ("ms", "device_ms", "device_clean_l2_ms", "slot_ms",
                                 "slot_device_ms", "bucket_ms", "bucket_device_ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": f"Q=1 nprobe={scale['nprobe']} cap={scale['cap']} d={SCALE_D} bf16 "
                 f"reconstruction table, N={SCALE_N:,}",
        "Q64": {k: v for k, v in scan[64].items() if k not in ("select", "max_abs_err")},
        "Q128": {k: v for k, v in scan[128].items() if k != "max_abs_err"},
        "ivf_probed_topk_Q1": scan["breakdown_Q1"],
        "batched_point": {dt: {**{k: b[k] for k in ("build_s", "nbuckets", "cap", "nprobe")},
                               **{f"Q{nq}": {k: v for k, v in r.items() if k != "max_abs_err"}
                                  for nq, r in b["Q"].items()}}
                          for dt, b in batched.items()},
    })
    kernels.append({
        "name": "kmeans_assign", "route": "cuda", "source": SOURCES["kmeans_assign"],
        "replaces": REPLACES["kmeans_assign"], "launches": pq_served["assign_launches"],
        "max_abs_err": asg["max_abs_err"], "ms": asg["ms"], "plain_ms": asg["plain_ms"],
        "bound_ms": asg["bound"][0], "bound_by": asg["bound"][1], "library_ms": None,
        "shape": f"N={SCALE_N:,} K={NLIST} d={SCALE_D} f32 (coarse quantizer), 3xTF32",
        "f32_cuda_core_bound_ms": asg["f32_cuda_core_bound_ms"],
        "product_alone_ms": asg["product_alone_ms"], "ivfpq_build_s": scale["build_s"],
        "pq_books": {"ms": asg["books_ms"], "plain_ms": asg["books_plain_ms"],
                     "shape": f"B={PQ_M} N=65,536 K=256 dsub={SCALE_D // PQ_M}"},
    })
    head, q64 = shapes_q8["Q1_N1M_d2048_int8_l2"], shapes_q8["Q64_N200003_d2048_int8_ip"]
    q256 = shapes_q8["Q256_N200003_d2048_int8_ip"]
    for name in ("groupmin_q8", "rescore_q8"):
        at_q64 = {k: q64[name][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
        extra = {}
        if name == "groupmin_q8":  # the int8 product alone; the compute-bound bench point
            at_q64["int_mm_product_ms"] = q64["int_mm_ms"]
            extra = {"bench_point": bench_q8,
                     "kernel_ms_by_batch": {f"Q={q}": r for q, r in head["routes"].items()}}
        else:  # slot order and group order: device ms at each Q
            at_q64["device_ms_by_order"] = q64[name]["device_ms_by_order"]
            extra = {"device_ms_by_order": head[name]["device_ms_by_order"],
                     "q256": {k: q256[name][k] for k in ("ms", "device_ms", "plain_ms",
                                                          "bound_ms", "bound_by",
                                                          "device_ms_by_order")},
                     "group_order": {
                         "source": SOURCES["rescore_q8"], "from_slots":
                             T.RESCORE_Q8_GROUP_ORDER_MIN_SLOTS,
                         "launches": q256["group_order"]["search_launches"],
                         **{k: q256["group_order"][k] for k in (
                             "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "shape")},
                         "q64": q64["group_order"]}}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": q8_served["launches"][name],
            "max_abs_err": max(s[name]["max_abs_err"] for s in shapes_q8.values()),
            "ms": head[name]["ms"], "device_ms": head[name]["device_ms"],
            "plain_ms": head[name]["plain_ms"], "bound_ms": head[name]["bound_ms"],
            "bound_by": head[name]["bound_by"], "library_ms": None,
            "shape": "Q=1 N=1,000,000 d=2048 int8 l2 k=20", "q64": at_q64, **extra,
        })
    for name, cases, shape in (
            ("topk_running", last["running"], "Q=1 N=1,000,000 d=2048 f32 l2 k=20"),
            ("topk_merged", last["merged"], "Q=1 N=1,000,000 d=2048 f32 l2 k=20 t=22")):
        head = cases["Q1_f32"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": last["launches"][name],
            "max_abs_err": max(last["edge"][name], *(c["max_abs_err"] for c in cases.values())),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "shape": shape,
            "shapes": {c: {k: v for k, v in r.items() if k != "max_abs_err"}
                       for c, r in cases.items()},
        })
    kernels.extend(sixth["kernels"])
    kernels.extend(seventh["kernels"])
    log(f"total {time.perf_counter() - t_start:.1f} s; flat serving p50 "
        f"{served['p50_ms']:.2f} ms, escalations {served['escalations']}; IVF-PQ build "
        f"{scale['build_s']:.1f} s, IVF-PQ serving p50 {pq_served['p50_ms']:.2f} ms; int8 "
        f"serving p50 {q8_served['p50_ms']:.2f} ms, escalations {q8_served['escalations']}, "
        f"top-10 overlap with f32 {q8_served['overlap']:.4f}; chi2 serving p50 "
        f"{q8_served['chi2_p50_ms']:.2f} ms; bench twin {sixth['bench']['value']} QPS at Q = "
        f"{BENCH_Q}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
