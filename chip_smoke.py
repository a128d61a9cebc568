#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

  0. set-up: versions, the card's name and power limit, TF32 off, the
     CUDA kernels built from image_search_engine_tpu_torch/csrc;
  1. each kernel of the two-phase search against its plain PyTorch
     version on the same tensors on the card, through FlatIndex.search
     and the three kernel wrappers directly, with CUDA-event timings;
  2. the main path through the user's entry points: 4,096 PNGs indexed by
     the port's indexer CLI (ResNet-50, flat l2, f32 store), the port's
     HTTP server queried with corpus images, and the kernel launch counts
     of that serving run.

Its last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``. Without CUDA it exits
non-zero before printing either.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
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
SOURCE = "image_search_engine_tpu_torch/csrc/topk_twophase.cu"
REPLACES = {
    "groupmin": "image_search_engine_tpu/ops/topk_pallas.py:252",
    "select_topt": "image_search_engine_tpu/ops/topk_pallas.py:361",
    "rescore": "image_search_engine_tpu/ops/topk_pallas.py:298",
}
EPS32 = float(np.finfo(np.float32).eps)


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

    res = {}
    for kname, fn, ref in (
        ("groupmin", lambda: T.groupmin(qf, store, knorms), lambda: T.groupmin_ref(qf, store, knorms)),
        ("select_topt", lambda: T.select_topt(mins, t), lambda: T.select_topt_ref(mins, t)),
        ("rescore", lambda: T.rescore(qf, store, knorms, ids),
         lambda: T.rescore_ref(qf, store, knorms, ids)),
    ):
        res[kname] = {"max_abs_err": errs[kname], "ms": median_ms(fn, flush),
                      "plain_ms": median_ms(ref, flush)}
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


def phase2(workdir: Path) -> dict:
    from image_search_engine_tpu_torch import engine as port_engine
    from image_search_engine_tpu_torch import indexer as port_indexer
    from image_search_engine_tpu_torch.ops import topk as T

    log("phase 2: the main path (indexer CLI -> HTTP server)")
    check_embedder()
    t0 = time.perf_counter()
    paths = write_corpus(workdir / "images", 4096)
    log(f"  wrote {len(paths)} PNGs in {time.perf_counter() - t0:.1f} s")
    art = workdir / "artifacts"
    t0 = time.perf_counter()
    port_indexer.cli_main(["--data-dir", str(workdir / "images"), "--artifacts-dir", str(art),
                           "--method", "dnn", "--dnn-model", "resnet50", "--index-type", "l2",
                           "--device", "cuda"])
    log(f"  indexed in {time.perf_counter() - t0:.1f} s")

    cfg, device = port_engine.parse_args(["--artifacts-dir", str(art), "--port", "0",
                                          "--device", "cuda"])
    engine, httpd = port_engine.make_server(cfg, device)  # prewarm builds + runs the kernels
    if engine.index.store.n != 4096 or engine.index.ntotal // 128 <= K + 4:
        raise AssertionError("the index must have more groups than t so the select runs")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        T.reset_launch_counts()
        lat = []
        for i in np.linspace(0, 4095, 8).astype(int):
            t0 = time.perf_counter()
            status, js = post_image(base + "/similar_images", paths[i].read_bytes())
            lat.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"query {i}: HTTP {status} {js}")
            pred = js["prediction"]
            dists = [p[0] for p in pred]
            if len(pred) != K or pred[0][2] != str(paths[i]):
                raise AssertionError(f"query {i}: {len(pred)} results, top-1 {pred[0][2]}")
            if not (np.all(np.isfinite(dists)) and dists == sorted(dists)):
                raise AssertionError(f"query {i}: distances not finite ascending: {dists}")
        counts = T.launch_counts()
        status, js = post_image(base + "/similar_images", b"not an image")
        if status != 400:
            raise AssertionError(f"garbage upload answered {status}, want 400")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("corpus") != 4096:
            raise AssertionError(f"healthz: {health}")
        stats = engine.stats.snapshot()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel did not launch while serving: {counts}")
    p50 = float(np.median(lat)) * 1e3
    log(f"  8 queries ok (top-1 = the query's own file); launches while serving {counts}; "
        f"request latency p50 {p50:.2f} ms (client clock, {len(lat)} requests); "
        f"certificate escalations {stats['certificate_escalations']}")
    return {"launches": counts, "p50_ms": p50,
            "escalations": stats["certificate_escalations"]}


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
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    head = shapes["Q1_N1M_d2048_f32_l2"]
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": served["launches"][name],
        "max_abs_err": max(s[name]["max_abs_err"] for s in shapes.values()),
        "ms": head[name]["ms"], "plain_ms": head[name]["plain_ms"],
        "shape": "Q=1 N=1,000,000 d=2048 f32 l2 k=20",
    } for name in ("groupmin", "select_topt", "rescore")]
    log(f"total {time.perf_counter() - t_start:.1f} s; serving p50 {served['p50_ms']:.2f} ms, "
        f"escalations {served['escalations']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
