#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

  0. set-up: versions, the card's name and power limit, TF32 off, the
     CUDA kernels built from image_search_engine_tpu_torch/csrc;
  1. each kernel of the two-phase search against its plain PyTorch
     version on the same tensors on the card, through FlatIndex.search
     and the three kernel wrappers directly, with CUDA-event timings;
  2. the flat main path through the user's entry points: 4,096 PNGs
     indexed by the port's indexer CLI (ResNet-50, flat l2, f32 store), the
     port's HTTP server queried with corpus images, and the kernel launch
     counts of that serving run;
  3. IVF-PQ: an IVFPQIndex (nlist 1024, nprobe 4, m 16) built on the card
     over 1,000,000 x 2048 clustered rows, its two kernels (k-means
     assignment, probed scan) and the probed top-k against their plain
     versions, the probed search against ADC and exact search; then the
     IVF-PQ path through the entry points (the same PNGs, indexer CLI with
     ``--index-type ivfpq --pq-rerank 64``, HTTP server) with the launch
     counts of the build and of serving;
  4. the int8 store and chi2: quantization on the card bit-identical to the
     numpy formula, both int8 kernels equal to their plain versions bit for
     bit at Q = 1 x 1M x 2048 and three other shapes plus an edge sweep,
     with timings (and ``torch._int_mm``'s product alone as a yardstick);
     then the same PNGs through ``--store-dtype int8`` and through
     ``--index-type chi2``, each served over HTTP with its launch counts;
  5. the last two package kernels through their entry points:
     ``topk_running`` (running top-k accumulators) at Q = 1 and 8 over 1M x
     2048 f32 and Q = 1 over bf16, ids equal to its plain version's, and
     ``topk_merged`` (the two-phase search in one cooperative launch) at Q =
     1 and 64 over 1M x 2048 f32 and bf16 and at Q = 2048 and 4096 over 1M x
     128 bf16, equal to ``topk_twophase(t_margin=2)`` bit for bit; edge
     sweeps for both; timings beside the two-phase search;
  6. bench.py's operating point (1M x 128 bf16, k = 10): the bench twin
     (``image_search_engine_tpu_torch.bench``) at Q = 4096 with few
     dispatches, each ported benchmark script's searches once with their
     recall@10 beside the production search's, the four phase-1 prototype
     kernels (group width, chunked columns, two-level mins in three
     layouts) against their plain versions at Q = 2048 (and 4096) plus an
     edge sweep, with timings beside ``groupmin``; then the tie order of the
     flat paths over a store whose second half repeats its first, and the
     cost of the k > 128 full scan's stable sort at 1M rows.

Before its last two lines it prints a JSON object describing the 13
kernels (launches, errors, times, bounds) and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without CUDA it
exits non-zero before printing any of them.
"""

from __future__ import annotations

import concurrent.futures as cf
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
    "select_topt": CSRC + "topk_twophase.cu",
    "rescore": CSRC + "topk_twophase.cu",
    "probed_scan": CSRC + "ivf_probed_scan.cu",
    "kmeans_assign": CSRC + "kmeans_assign.cu",
    "groupmin_q8": CSRC + "topk_twophase_q8.cu",
    "rescore_q8": CSRC + "topk_twophase_q8.cu",
    "topk_running": CSRC + "topk_running.cu",
    "topk_merged": CSRC + "topk_merged.cu",
    "groupmin_width": CSRC + "groupmin_variants.cu",
    "groupmin_chunked": CSRC + "groupmin_variants.cu",
    "groupmin_two_level": CSRC + "groupmin_variants.cu",
    "groupmin_two_level_layouts": CSRC + "groupmin_variants.cu",
}
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
}
EPS32 = float(np.finfo(np.float32).eps)
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, bf16 and int8 on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# phase 3: the repo's 1M IVF operating point at the ResNet-50 width, over
# synthetic rows: 4,096 Gaussian centres in a 64-d latent space, projected
# to 2048-d (the latent width is a choice, not a measured property of image
# embeddings; recalls on this corpus describe this corpus only)
SCALE_N, SCALE_D, SCALE_CENTRES, SCALE_LATENT = 1_000_000, 2048, 4096, 64
NLIST, NPROBE, PQ_M = 1024, 4, 16


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
    """Distances within tol; id sets equal except ties at the k-th distance."""
    if not np.allclose(d, rd, rtol=0, atol=tol):
        raise AssertionError(f"{what}: distances differ by {np.abs(d - rd).max()} > {tol}")
    for r in range(d.shape[0]):
        kth = rd[r, -1]
        a = set(i[r][np.abs(d[r] - kth) > tol].tolist())
        b = set(ri[r][np.abs(rd[r] - kth) > tol].tolist())
        if a != b:
            raise AssertionError(f"{what}: query {r} ids differ beyond ties: {sorted(a ^ b)[:8]}")


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


def check_kernels(name, qf, store, knorms, tol):
    """Each kernel against its plain version on the same inputs; the select
    gets the same mins in both versions and must match bit for bit.
    Returns ({kernel: max_abs_err}, mins, candidate ids, t)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    errs = {}
    mins = T.groupmin(qf, store, knorms)
    errs["groupmin"] = max_abs_err(mins, T.groupmin_ref(qf, store, knorms))
    t = min(K + 4, mins.shape[1])
    vals, ids = T.select_topt(mins, t)
    rv, rids = T.select_topt_ref(mins, t)
    if not (torch.equal(vals, rv) and torch.equal(ids, rids)):
        raise AssertionError(f"{name}: select differs from its plain version")
    errs["select_topt"] = 0.0
    scores = T.rescore(qf, store, knorms, ids)
    errs["rescore"] = max_abs_err(scores, T.rescore_ref(qf, store, knorms, ids))
    # one scoring routine in both kernels: a group's min is its rows' min
    if not torch.equal(scores.view(qf.shape[0], t, -1).amin(2), torch.gather(mins, 1, ids.long())):
        raise AssertionError(f"{name}: phase-1 group mins differ from phase-2 scores")
    for k in ("groupmin", "rescore"):
        if errs[k] > tol:
            raise AssertionError(f"{name}: {k} error {errs[k]} > tolerance {tol}")
    return errs, mins, ids, t


def check_shape(name, x, nq, metric, dtype, gen, flush, *, pad_rows=None, q_scale=1.0):
    """One timed phase-1 shape: the search and the kernels checked, then
    each kernel and its plain version timed. Returns {kernel:
    {max_abs_err, ms, plain_ms}}."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
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
    peak = F32_FLOPS if isz == 4 else BF16_FLOPS
    rows = torch.unique(ids).numel() * T.GROUP  # distinct candidate rows this run reads
    bounds = {
        "groupmin": bound(n * d * isz + n * 4 + nq * d * isz + nq * ng * 4, 2 * nq * n * d, peak),
        "select_topt": bound(nq * ng * 4 + nq * t * 8, 0, peak),
        "rescore": bound(rows * (d * isz + 4) + nq * d * isz + nq * t * (4 + T.GROUP * 4),
                         2 * nq * t * T.GROUP * d, peak),
    }
    res = {}
    for kname, fn, ref, lib in (
        ("groupmin", lambda: T.groupmin(qf, store, knorms), lambda: T.groupmin_ref(qf, store, knorms),
         None),
        ("select_topt", lambda: T.select_topt(mins, t), lambda: T.select_topt_ref(mins, t),
         lambda: torch.topk(mins, t, dim=1, largest=False)),
        ("rescore", lambda: T.rescore(qf, store, knorms, ids),
         lambda: T.rescore_ref(qf, store, knorms, ids), None),
    ):
        res[kname] = {"max_abs_err": errs[kname], "ms": median_ms(fn, flush),
                      "plain_ms": median_ms(ref, flush),
                      "library_ms": None if lib is None else median_ms(lib, flush),
                      "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    smetric = "l2" if metric == "l2" else "ip"
    search_ms = median_ms(lambda: T.topk_twophase(qs, store, K, smetric, x_norms=norms), flush)
    scan_ms = median_ms(lambda: local_topk_with_norms(qs, store, norms, K, smetric), flush)
    log(f"  {name}: tol {tol:.3g}; " + "; ".join(
        f"{k} err {v['max_abs_err']:.3g} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms)"
        for k, v in res.items())
        + f"; two-phase search {search_ms:.4f} ms, plain full scan {scan_ms:.4f} ms")
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


def phase1() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    log("phase 1: kernels against their plain versions")
    shapes = {}
    x = torch.randn(1_000_000, 2048, device="cuda", generator=gen)
    shapes["Q1_N1M_d2048_f32_l2"] = check_shape("Q=1 N=1,000,000 d=2048 f32 l2", x, 1,
                                                "l2", "f32", gen, flush)
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
    return shapes


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
        IV.probed_scan.launches = 0
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
        counts = {**T.launch_counts(), "probed_scan": IV.probed_scan.launches}
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
    log(f"  8 queries ok (top-1 = the query's own file); launches while serving {counts}; "
        f"request latency p50 {out['p50_ms']:.2f} ms (client clock, 8 requests); "
        f"certificate escalations {out['escalations']}")
    return {"launches": counts, "p50_ms": out["p50_ms"], "escalations": out["escalations"],
            "paths": paths, "art": art}


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


def phase3_scale() -> dict:
    """IVF-PQ over 1M x 2048 clustered rows: build, each kernel against its
    plain version, timings, and the search against ADC and exact search."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.index.ivf import IVFPQIndex
    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import kmeans as KM

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
    books_ms = median_ms(lambda: KM.assign(resid, books), flush)
    books_plain_ms = median_ms(lambda: KM.assign_ref(resid, books), flush)
    a_bound = bound(SCALE_N * SCALE_D * 4 + NLIST * (SCALE_D * 4 + 4) + SCALE_N * 8,
                    2 * SCALE_N * NLIST * SCALE_D, F32_FLOPS)
    log(f"  assign N={SCALE_N:,} K={NLIST} d={SCALE_D}: err {err_c:.3g} (tol {tol_c:.3g}), "
        f"{bad_c} codes differ at near-ties; {assign_ms:.3f} ms (plain {assign_plain_ms:.3f} "
        f"ms, bound {a_bound[0]:.3f} ms by {a_bound[1]}); PQ books B={PQ_M} N=65,536 K=256 "
        f"dsub={SCALE_D // PQ_M}: err {err_b:.3g} (tol {tol_b:.3g}), {bad_b} near-tie codes, "
        f"{books_ms:.3f} ms (plain {books_plain_ms:.3f} ms)")
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
        tol = score_tol(qf, rnorms)
        err = max_abs_err(IV.probed_scan(qf, recon, rnorms, probe),
                          IV.probed_scan_ref(qf, recon, rnorms, probe))
        if err > tol:
            raise AssertionError(f"probed_scan Q={nq}: error {err} > tolerance {tol}")
        d, i, ok = IV.ivf_probed_topk(q, bc, recon, rnorms, lists, K, nprobe)
        rd, ri = plain_probed_topk(q, bc, recon, rnorms, lists, K, nprobe)
        if not bool(ok.all()):
            raise AssertionError(f"probed top-k Q={nq}: invalid slots among the top {K}")
        assert_same_topk(d.cpu().numpy(), i.cpu().numpy(), rd.cpu().numpy(), ri.cpu().numpy(),
                         2 * tol, f"probed top-k Q={nq}")
        ub = torch.unique(probe).numel()  # distinct buckets this run reads
        scan[nq] = {
            "max_abs_err": err, "tol": tol,
            "ms": median_ms(lambda: IV.probed_scan(qf, recon, rnorms, probe), flush),
            "plain_ms": median_ms(lambda: IV.probed_scan_ref(qf, recon, rnorms, probe), flush),
            "topk_ms": median_ms(lambda: IV.ivf_probed_topk(q, bc, recon, rnorms, lists, K,
                                                            nprobe), flush),
            "bound": bound(ub * cap * (SCALE_D * 2 + 4) + nq * SCALE_D * 2
                           + nq * nprobe * (4 + cap * 4), 2 * nq * nprobe * cap * SCALE_D,
                           BF16_FLOPS),
            "buckets": ub,
        }
        log(f"  probed_scan Q={nq} (bf16 table, {nprobe} probes x cap {cap}, {ub} distinct "
            f"buckets): err {err:.3g} (tol {tol:.3g}); {scan[nq]['ms']:.4f} ms (plain "
            f"{scan[nq]['plain_ms']:.4f} ms, bound {scan[nq]['bound'][0]:.4f} ms by "
            f"{scan[nq]['bound'][1]}); probed top-{K} {scan[nq]['topk_ms']:.4f} ms, ids = plain "
            f"route's")
    qf = q64.contiguous()
    probe = IV.rank_buckets(qf, bc, nprobe).to(torch.int32).contiguous()
    err_raw = max_abs_err(IV.probed_scan(qf, index.packed, index.packed_norms, probe),
                          IV.probed_scan_ref(qf, index.packed, index.packed_norms, probe))
    if err_raw > score_tol(qf, index.packed_norms):
        raise AssertionError(f"probed_scan on the f32 table: error {err_raw}")
    scan["max_abs_err"] = max(scan[1]["max_abs_err"], scan[64]["max_abs_err"], err_raw)

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
    log(f"  search_batched(k={K}, rerank=64) incl. host transfer: Q=1 {serve_ms[1]:.3f} ms, "
        f"Q=64 {serve_ms[64]:.3f} ms")
    del index, recon, rnorms, x
    torch.cuda.empty_cache()
    return {"build_s": build_s, "scan": scan, "nprobe": nprobe, "cap": cap,
            "assign": {"max_abs_err": max(err_c, err_b), "ms": assign_ms,
                       "plain_ms": assign_plain_ms, "bound": a_bound}}


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
    counts = {k: out["launches"][k] for k in ("probed_scan", "select_topt")}
    if assign_launches == 0 or not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel did not launch: assign {assign_launches} during the "
                             f"build, {counts} while serving")
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


def check_shape_q8(name, x, nq, metric, gen, flush, *, pad_rows=None, q_scale=1.0,
                   int_mm_rows=0):
    """One timed int8 shape: FlatIndex(dtype="int8") over x, the search and
    both kernels checked, then each kernel and its plain version timed.
    ``int_mm_rows`` > 0 also times ``torch._int_mm``'s int8 product of the
    queries with that many store rows (the product alone, a yardstick).
    Returns {kernel: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}} and, with ``int_mm_rows``, "int_mm_ms"."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex
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
    qs, qi, qscale, knorms = check_search_q8(name, index, q)
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
                      "plain_ms": median_ms(ref, flush, reps=5), "library_ms": None,
                      "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    smetric = "l2" if metric == "l2" else "ip"
    search_ms = median_ms(lambda: T.topk_twophase(qs, store, K, smetric, x_norms=norms,
                                                  x_scale=scales), flush)
    scan_ms = median_ms(lambda: local_topk_with_norms(qs, store, norms, K, smetric,
                                                      scales=scales), flush, reps=5)
    extra = ""
    if int_mm_rows:
        try:
            res["int_mm_ms"] = median_ms(lambda: torch._int_mm(qi, store[:int_mm_rows].t()), flush)
            extra = (f"; torch._int_mm product alone (Q={nq} x {int_mm_rows:,} rows) "
                     f"{res['int_mm_ms']:.4f} ms")
        except RuntimeError as e:  # a yardstick only: record why it is missing
            res["int_mm_ms"] = None
            extra = f"; torch._int_mm refused: {e}"
    log(f"  {name}: " + "; ".join(
        f"{k} err {v['max_abs_err']:.3g} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms, bound "
        f"{v['bound_ms']:.4f} ms by {v['bound_by']})" for k, v in res.items() if k != "int_mm_ms")
        + f"; two-phase search {search_ms:.4f} ms, plain full scan {scan_ms:.4f} ms" + extra)
    return res


def edge_sweep_q8(gen) -> None:
    """Phase 1's edge shapes over an int8 store, untimed: 1, 2, 4 and
    8-query tiles (full and partial), rows that are not 16-byte multiples
    (d = 130, 2049: the scalar loop), a one-group store, ragged last groups;
    l2, ip and cosine. Every kernel output equals its plain version."""
    import torch

    from image_search_engine_tpu_torch.index.flat import FlatIndex

    cases = 0
    for metric in ("l2", "ip", "cosine"):
        for n, d, nq in ((100, 16, 1), (1000, 130, 3), (3000, 256, 2), (5003, 2049, 9),
                         (20_000, 64, 17)):
            name = f"edge N={n} d={d} Q={nq} int8 {metric}"
            x = torch.randn(n, d, device="cuda", generator=gen)
            q = torch.randn(nq, d, device="cuda", generator=gen)
            index = FlatIndex(metric, dtype="int8", device="cuda").add(x)
            _, qi, qscale, knorms = check_search_q8(name, index, q)
            check_kernels_q8(name, qi, qscale, index.store.vectors, index.store.scales, knorms)
            cases += 1
    log(f"  int8 edge sweep: {cases} shapes ok, every kernel output equal to its plain version")


def phase4_kernels() -> dict:
    import torch

    log("phase 4: the int8 store and its kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    check_quantization(gen)
    shapes = {}
    x = torch.randn(1_000_000, 2048, device="cuda", generator=gen)
    shapes["Q1_N1M_d2048_int8_l2"] = check_shape_q8("Q=1 N=1,000,000 d=2048 int8 l2", x, 1,
                                                    "l2", gen, flush)
    del x
    torch.cuda.empty_cache()
    x = torch.randn(200_003, 2048, device="cuda", generator=gen)
    shapes["Q64_N200003_d2048_int8_ip"] = check_shape_q8(
        "Q=64 N=200,003 d=2048 int8 ip", x, 64, "ip", gen, flush, int_mm_rows=200_000)
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
            "topk_running": 0, "probed_scan": 0}
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
    """topk_merged (``got``, or run now) equal to topk_twophase at the same
    margin bit for bit (distances, ids, certificate), every certificate
    True; then its kernel wrapper: each candidate group's stage-1 min equal
    to the min of its stage-3 rows, and (``plain``) mins and scores against
    the plain version. Returns the largest kernel error (0.0 unchecked)."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T
    from image_search_engine_tpu_torch.ops import topk_merged as TM

    if got is None:
        got = TM.topk_merged(q, x, k, metric, x_norms=x_norms, with_certificate=True)
    want = T.topk_twophase(q, x, k, metric, x_norms=x_norms, t_margin=MERGED_MARGIN,
                           with_certificate=True)
    for what, a, b in zip(("distances", "ids", "certificates"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: topk_merged {what} differ from topk_twophase's")
    if not bool(got[2].all()):
        raise AssertionError(f"{name}: {int((~got[2]).sum())} certificates failed")
    qs, xs, sn = search_inputs(q, x, metric)
    smetric = "l2" if metric == "l2" else "ip"
    qf = qs.to(xs.dtype).contiguous() * (1.0 if smetric == "l2" else 0.5)
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
        f"equal to topk_twophase bit for bit, largest kernel error {mworst:.3g}")
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
        log(f"  topk_merged {c} (N={n:,} d={d} {str(x.dtype)[6:]} k={k}, t={t}): = "
            f"topk_twophase bit for bit, certificates all True, kernel err {err:.3g}; kernel "
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

BENCH_Q, BENCH_ITERS, PROTO_Q = 4096, 5, 2048
PROTO_REPS = 3  # the CUDA-core sweeps take ~0.2 s a call at Q = 2048
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


def check_variants(name, qf, x, norms, nf32, want, *, layouts=None, width=True, chunked=True):
    """The four prototype kernels on (qf, x): each f32 output within
    score_tol of its plain version; width 128 and the two-level group mins
    equal to ``want`` (production ``groupmin`` transposed) bit for bit; the
    bf16 subgroup mins within one bf16 ulp of the plain version's, and each
    group min's bf16 rounding equal to the min of its subgroup mins. ``norms``
    score the chunked kernel, ``nf32`` the others (the scripts' norms);
    ``width`` and ``chunked`` include those kernels.
    Returns {kernel: max_abs_err} (the two-level's in bf16 ulps too)."""
    import torch
    import torch.nn.functional as F

    from image_search_engine_tpu_torch.ops import groupmin_variants as GV

    errs = {}
    tol = score_tol(qf, torch.cat([norms, nf32]))
    for g in GV.WIDTHS if width else ():
        got = GV.groupmin_width(qf, x, nf32, g)
        errs[f"width{g}"] = max_abs_err(got, GV.groupmin_width_ref(qf, x, nf32, g))
        if g == 128 and not torch.equal(got, want):
            raise AssertionError(f"{name}: groupmin_width(128) differs from groupmin")
    for c in GV.CHUNKS if chunked else ():
        got = GV.groupmin_chunked(qf, x, norms, c)
        errs[f"chunk{c}"] = max_abs_err(got, GV.groupmin_chunked_ref(qf, x, norms))
    rg, rs = GV.groupmin_two_level_ref(qf, x, nf32)
    for lay in layouts or GV.LAYOUTS:
        gm, sm = GV.groupmin_two_level(qf, x, nf32, lay)
        if not torch.equal(gm, want):
            raise AssertionError(f"{name}: two-level {lay} group mins differ from groupmin")
        errs[f"two_level_{lay}"] = max_abs_err(gm, rg)
        ulps = bf16_ulps(sm, rs)
        if ulps > 1.0:
            raise AssertionError(f"{name}: two-level {lay} subgroup mins {ulps} bf16 ulps off")
        errs[f"two_level_{lay}_ulps"] = ulps
        per = 4
        pad = -sm.shape[1] % per
        smin4 = F.pad(sm.float(), (0, pad), value=float("inf")).view(sm.shape[0], -1, per).amin(2)
        if not torch.equal(gm.T.to(torch.bfloat16).float(), smin4):
            raise AssertionError(f"{name}: two-level {lay} group mins are not their subgroups' min")
    worst = max(v for k, v in errs.items() if not k.endswith("_ulps"))
    if worst > tol:
        raise AssertionError(f"{name}: prototype kernel error {worst} > tolerance {tol}")
    return errs


def edge_sweep_variants(gen) -> float:
    """Every width, chunk and layout at N in {1, 31, 32, 33, 127, 129, 5000}
    x Q in {1, 7, 64}, d = 128 (and d = 130, rows of no 16-byte multiple,
    for the width and two-level kernels: scalar row loads), untimed. Returns the largest
    error."""
    import torch

    from image_search_engine_tpu_torch.ops import topk as T

    worst, cases = 0.0, 0
    for n in (1, 31, 32, 33, 127, 129, 5000):
        for nq in (1, 7, 64):
            for d in (128, 130):
                x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
                q = torch.randn(nq, d, device="cuda", generator=gen).to(torch.bfloat16)
                nf32 = (torch.randn(n, d, device="cuda", generator=gen) ** 2).sum(1)
                norms = (x.float() ** 2).sum(1)
                want = T.groupmin(q, x, nf32).T
                errs = check_variants(f"variants edge N={n} Q={nq} d={d}", q, x, norms, nf32, want,
                                      chunked=d % 8 == 0)
                worst = max(worst, *(v for k, v in errs.items() if not k.endswith("_ulps")))
                cases += 1
    log(f"  prototype edge sweep: {cases} shapes, every width, chunk and layout; largest error "
        f"{worst:.3g}")
    return worst


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
    ascending id order, and topk_merged equal to topk_twophase bit for bit.
    FlatIndex f32 and int8 (l2, ip), topk_twophase_safe, topk_merged, and
    k = 200 (the full-scan path)."""
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
    log(f"  ties: {checks} searches over {2 * TIE_HALF:,} x {TIE_D} rows (second half = first "
        f"half), ids equal to the stable plain scan's, {ties} tied neighbours all in ascending "
        f"id order; topk_merged = topk_twophase bit for bit")
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


def phase6() -> dict:
    """bench.py's operating point: the main path (bench twin, then each
    ported script's searches once; launch counts set to 0 just before, read
    just after), then the four prototype kernels checked and timed, the edge
    sweep, the tie check and the full scan's sort."""
    import torch

    from image_search_engine_tpu_torch import bench
    from image_search_engine_tpu_torch.benchmarks import common
    from image_search_engine_tpu_torch.benchmarks import rescore_variants2 as RV2
    from image_search_engine_tpu_torch.benchmarks import subgroup_proto as SP
    from image_search_engine_tpu_torch.benchmarks import subgroup_variants as SV
    from image_search_engine_tpu_torch.benchmarks import sweep_chunked as SC
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import topk as T

    log(f"phase 6: bench.py's operating point ({BENCH_N:,} x {BENCH_D} bf16 store, k = {BENCH_K})")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2
    t0 = time.perf_counter()
    store = common.make_store(BENCH_N, BENCH_D, seed=0, device="cuda")
    nbf, nf32 = store.norms_bf16_rows(), store.norms_f32_rows()
    torch.cuda.synchronize()
    log(f"  store built in {time.perf_counter() - t0:.1f} s (seed 0, bench.py's data)")

    def recall_of(fn, q):
        return common.recall(fn(q)[1][:8], common.float64_topk_ids(q[:8], store.x32, BENCH_K))

    T.reset_launch_counts()
    GV.reset_launch_counts()
    out = bench.run(store, BENCH_Q, BENCH_ITERS)
    print(json.dumps(out), flush=True)
    q2048 = common.queries(store, 1, PROTO_Q)[0]
    recalls = {"rescore_variants2": {name: recall_of(fn, q2048)
                                     for name, fn in RV2.searches(store.x, nf32)}}
    sums = {name: float(fn(q2048)) for name, fn in SC.sweeps(store.x, nbf)}
    torch.cuda.synchronize()
    two_level_before = GV.groupmin_two_level.launches
    q4096 = common.queries(store, 1, BENCH_Q)[0]
    recalls["subgroup_proto"] = {f"{name} Q={q.shape[0]}": recall_of(fn, q)
                                 for q in (q2048, q4096) for name, fn in SP.searches(store.x, nf32)}
    proto_launches = GV.groupmin_two_level.launches - two_level_before
    recalls["subgroup_variants"] = {name: recall_of(fn, q2048)
                                    for name, fn in SV.searches(store.x, nf32)}
    torch.cuda.synchronize()
    launches = {"groupmin_width": GV.groupmin_width.launches,
                "groupmin_chunked": GV.groupmin_chunked.launches,
                "groupmin_two_level": proto_launches,
                "groupmin_two_level_layouts": GV.groupmin_two_level.launches - proto_launches,
                "groupmin": T.groupmin.launches}
    if not all(launches.values()):
        raise AssertionError(f"phase 6 main path: a kernel did not launch: {launches}")
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
        f"{out['exactness_certified_frac']}; sweep_chunked sums agree; launches {launches}")

    # the four kernels against their plain versions, then timed
    qf = q2048.to(torch.bfloat16).contiguous()
    want = T.groupmin(qf, store.x, nf32).T
    errs = check_variants("Q=2048", qf, store.x, nbf, nf32, want)
    qf4 = q4096.to(torch.bfloat16).contiguous()
    errs4 = check_variants("Q=4096", qf4, store.x, nbf, nf32, T.groupmin(qf4, store.x, nf32).T,
                           layouts=("v1",), width=False, chunked=False)
    worst_edge = edge_sweep_variants(gen)
    n, d = BENCH_N, BENCH_D
    ng, nsub = T.num_groups(n), -(-n // GV.SUB)

    def bnd(nq, out_bytes):
        return bound(n * d * 2 + n * 4 + nq * d * 2 + out_bytes, 2 * nq * n * d, BF16_FLOPS)

    x = store.x
    ms = lambda fn: median_ms(fn, flush, reps=PROTO_REPS)  # noqa: E731
    times = {"groupmin": ms(lambda: T.groupmin(qf, x, nf32)),
             "product": ms(lambda: torch.matmul(qf, x.T))}
    for g in GV.WIDTHS:
        times[f"width{g}"] = ms(lambda: GV.groupmin_width(qf, x, nf32, g))
    for c in GV.CHUNKS:
        times[f"chunk{c}"] = ms(lambda: GV.groupmin_chunked(qf, x, nbf, c))
    for lay in GV.LAYOUTS:
        times[f"two_level_{lay}"] = ms(lambda: GV.groupmin_two_level(qf, x, nf32, lay))
    times["two_level_v1_Q4096"] = ms(lambda: GV.groupmin_two_level(qf4, x, nf32, "v1"))
    times["groupmin_Q4096"] = ms(lambda: T.groupmin(qf4, x, nf32))
    plain = {"width": median_ms(lambda: GV.groupmin_width_ref(qf, x, nf32, 128), flush, reps=2),
             "two_level": median_ms(lambda: GV.groupmin_two_level_ref(qf, x, nf32), flush, reps=2),
             "chunked": median_ms(lambda: GV.groupmin_chunked_ref(qf, x, nbf), flush, reps=2)}
    log(f"  prototype kernels at Q={PROTO_Q} (N={n:,} d={d} bf16): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()) + "; plain " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in plain.items()) + "; errors " + "; ".join(
        f"{k} {v:.3g}"
        for k, v in {**errs, **{f"{k} Q=4096": v for k, v in errs4.items()}}.items()))
    tie = check_ties(gen)
    del store, nbf, nf32, x, want
    torch.cuda.empty_cache()
    sort = full_scan_sort_cost(gen, flush)

    def worst(prefix):
        return max(worst_edge, *(v for e in (errs, errs4) for k, v in e.items()
                                 if k.startswith(prefix) and not k.endswith("_ulps")))

    b2048 = {"groupmin_width": bnd(PROTO_Q, -(-n // 32) * PROTO_Q * 4),
             "groupmin_chunked": bnd(PROTO_Q, ng * PROTO_Q * 4),
             "groupmin_two_level": bnd(PROTO_Q, ng * PROTO_Q * 4 + nsub * PROTO_Q * 2)}
    entries = [
        ("groupmin_width", times["width32"], plain["width"], b2048["groupmin_width"],
         worst("width"),
         "Q=2048 N=1,000,000 d=128 bf16 G=32 (f32-row norms)",
         {f"G={g}_ms": times[f"width{g}"] for g in GV.WIDTHS}),
        ("groupmin_chunked", times["chunk512"], plain["chunked"], b2048["groupmin_chunked"],
         worst("chunk"), "Q=2048 N=1,000,000 d=128 bf16 chunk=512 (bf16-row norms)",
         {f"chunk={c}_ms": times[f"chunk{c}"] for c in GV.CHUNKS}),
        ("groupmin_two_level", times["two_level_v1"], plain["two_level"],
         b2048["groupmin_two_level"], worst("two_level_v1"),
         "Q=2048 N=1,000,000 d=128 bf16 v1 (f32-row norms)",
         {"Q=4096_ms": times["two_level_v1_Q4096"],
          "Q=4096_bound_ms": bnd(BENCH_Q, ng * BENCH_Q * 4 + nsub * BENCH_Q * 2)[0]}),
        ("groupmin_two_level_layouts", times["two_level_v3"], plain["two_level"],
         b2048["groupmin_two_level"], worst("two_level"),
         "Q=2048 N=1,000,000 d=128 bf16 v3 (f32-row norms)",
         {f"{lay}_ms": times[f"two_level_{lay}"] for lay in GV.LAYOUTS}),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": p, "bound_ms": b[0],
        "bound_by": b[1], "library_ms": None, "shape": shape,
        "product_alone_ms": times["product"], "groupmin_ms": times["groupmin"], "variants": extra,
    } for name, t, p, b, err, shape, extra in entries]
    return {"bench": out, "kernels": kernels, "times": times, "ties": tie, "sort": sort}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from image_search_engine_tpu_torch.ops import _kernels

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

    shapes = phase1()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        served = phase2(workdir)
        scale = phase3_scale()
        pq_served = phase3_entry(workdir, served["paths"])
        shapes_q8 = phase4_kernels()
        q8_served = phase4_entry(workdir, served["paths"], served["art"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    last = phase5()
    sixth = phase6()

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
    scan, asg = scale["scan"], scale["assign"]
    kernels.append({
        "name": "probed_scan", "route": "cuda", "source": SOURCES["probed_scan"],
        "replaces": REPLACES["probed_scan"], "launches": pq_served["launches"]["probed_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": scan[1]["ms"], "plain_ms": scan[1]["plain_ms"],
        "bound_ms": scan[1]["bound"][0], "bound_by": scan[1]["bound"][1], "library_ms": None,
        "shape": f"Q=1 nprobe={scale['nprobe']} cap={scale['cap']} d={SCALE_D} bf16 "
                 f"reconstruction table, N={SCALE_N:,}",
    })
    kernels.append({
        "name": "kmeans_assign", "route": "cuda", "source": SOURCES["kmeans_assign"],
        "replaces": REPLACES["kmeans_assign"], "launches": pq_served["assign_launches"],
        "max_abs_err": asg["max_abs_err"], "ms": asg["ms"], "plain_ms": asg["plain_ms"],
        "bound_ms": asg["bound"][0], "bound_by": asg["bound"][1], "library_ms": None,
        "shape": f"N={SCALE_N:,} K={NLIST} d={SCALE_D} f32 (coarse quantizer)",
    })
    head, q64 = shapes_q8["Q1_N1M_d2048_int8_l2"], shapes_q8["Q64_N200003_d2048_int8_ip"]
    for name in ("groupmin_q8", "rescore_q8"):
        at_q64 = {k: q64[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        if name == "groupmin_q8":  # a tensor-core phase 1's yardstick: the int8 product alone
            at_q64["int_mm_product_ms"] = q64["int_mm_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": q8_served["launches"][name],
            "max_abs_err": max(s[name]["max_abs_err"] for s in shapes_q8.values()),
            "ms": head[name]["ms"], "plain_ms": head[name]["plain_ms"],
            "bound_ms": head[name]["bound_ms"], "bound_by": head[name]["bound_by"],
            "library_ms": None, "shape": "Q=1 N=1,000,000 d=2048 int8 l2 k=20",
            "q64": at_q64,
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
