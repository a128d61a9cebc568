"""Serving programs: feature prologue + search core + host epilogue.

Port of the single-device part of ``image_search_engine_tpu/serving/
fused.py``. Every dispatch runs one prologue (preprocess, backbone) and one
search core on the device, then one host transfer in the epilogue.
Families: flat (the certified two-phase top-k over an f32, bf16 or int8
store, or the chunked chi2 scan; the certificate retry re-runs the whole
dispatch at the wide margin, as in the JAX package), IVF and IVF-PQ (the
probed-scan kernel; IVF-PQ scans a reconstruction table built once at
start, with an optional exact rerank in the same dispatch).

On a CUDA device each dispatch is captured once as a CUDA graph and then
replayed: the counterpart of the JAX package's jitted program, keyed on
what its jit keys on (the batch shape, the family's statics and the
certificate's margin). The first call of a key runs the dispatch eagerly
once (the kernel library built and loaded, cuDNN's plans made on this
thread, the allocator warm), then captures it reading a static device input
buffer; every call copies its images into that buffer and replays. On the
CPU the same dispatch runs eagerly. ``wrap_serving`` adds the host resize,
the device thread and request micro-batching (serving/batching.py). The
BoVW method serves through the flat family with its own prologue (describe,
quantize, histogram, BM25); dHash through a Hamming-scan core (the JAX
engine runs dHash eagerly per request; here it is one captured dispatch
like the others). The multi-host coordinator waits for ROADMAP.md (queue 1
item 7).
"""

from __future__ import annotations

import importlib
import inspect
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from image_search_engine_tpu_torch.index.flat import MAX_KERNEL_K, WIDE_MARGIN, faiss_tail
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.ivf import ivf_probed_topk
from image_search_engine_tpu_torch.parallel.topk import local_topk_with_norms

log = logging.getLogger(__name__)

#: the ops modules whose kernel wrappers count their launches in
#: ``<wrapper>.launches`` and ``<wrapper>.<route>_launches``
COUNTED_MODULES = ("topk", "ivf", "kmeans", "topk_merged", "groupmin_variants",
                   "rescore_variants")


def launch_counters() -> dict:
    """Every kernel wrapper's launch counters: {(wrapper, attribute):
    count} over :data:`COUNTED_MODULES`."""
    counts = {}
    for name in COUNTED_MODULES:
        mod = importlib.import_module(f"image_search_engine_tpu_torch.ops.{name}")
        for fn in vars(mod).values():
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__:
                for attr, n in vars(fn).items():
                    if attr.endswith("launches") and isinstance(n, int):
                        counts[(fn, attr)] = n
    return counts


class CudaGraphs:
    """How :class:`BatchedSearch` captures on a CUDA device: each program
    warmed eagerly, then captured, on one side stream, every graph in one
    memory pool. The warm run is on the capture's stream, so what the
    kernels' wrappers keep per stream (the split select's ticket counters)
    is made there outside the capture, in ordinary memory, and a later
    graph's capture cannot place it where an earlier graph's scratch
    lives."""

    def __init__(self):
        self.pool = None
        self.stream = None

    def warm(self, run: Callable) -> None:
        """``run()`` once eagerly on the capture stream, waited for."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            run()
        self.stream.synchronize()

    def capture(self, run: Callable):
        """(replay, outputs) of ``run()`` captured as one CUDA graph. A
        dispatch that cannot be captured (a host read of a device value, a
        pageable copy) raises here."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = run()
        return graph.replay, out

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the graphs' pool."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))


@dataclass
class Program:
    """One captured dispatch: its static input buffer, its replay and
    static outputs, the launches a replay makes ({(wrapper, attribute):
    n}, recorded at capture), the warm run's and the capture's seconds, and
    its replays."""

    static_in: torch.Tensor
    replay: Callable
    out: tuple
    launches: dict
    warm_s: float
    capture_s: float
    replays: int = 0


class BatchedSearch:
    """``prologue(images) -> feats`` and ``core(feats, statics, t_margin)
    -> out`` as one dispatch, wrapped by the family's ``epilogue(out, k,
    retry) -> (d, i)``: ``self(images, k) -> (d, i)``. ``statics_fn(k)``
    clamps k to the candidate pool (with IVF-PQ's rerank width).

    With a capture backend (``graphs``; :class:`CudaGraphs` by default on
    a CUDA device) each (batch, image shape, statics, t_margin) is
    captured at its first call and replayed since (:attr:`programs`); a
    capture raises rather than falling back to eager runs. A capture
    launches nothing, so the kernels' launch counters it moved are put
    back and each replay adds the launches the capture recorded: counts
    stay per dispatch run. ``raw_dispatch`` is the eager, uncaptured
    dispatch; ``dispatch`` the served one. ``replays`` and ``eager_runs``
    count served dispatches by how they ran (the warm run before each
    capture is an eager run; ``raw_dispatch`` counts in neither).
    """

    def __init__(self, prologue: Callable, core: Callable, statics_fn: Callable,
                 epilogue: Callable, device, graphs=None):
        self.device = torch.device(device)
        self.graphs = CudaGraphs() if graphs is None and self.device.type == "cuda" else graphs
        self._prologue, self._core, self._statics_fn = prologue, core, statics_fn
        self._epilogue = epilogue
        self.programs: dict = {}
        self.eager_runs = 0
        # one dispatch at a time: a replay's static buffers are reused
        self._lock = threading.RLock()

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())

    @torch.inference_mode()
    def _run(self, x: torch.Tensor, statics, t_margin):
        return self._core(self._prologue(x), statics, t_margin)

    def raw_dispatch(self, images: np.ndarray, k: int, t_margin=None):
        """The dispatch run eagerly: upload, prologue, core."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        return self._run(x, self._statics_fn(k), t_margin)

    def dispatch(self, images: np.ndarray, k: int, t_margin=None):
        """The served dispatch: the key's program replayed (captured at its
        first call), or an eager run where there is no capture backend."""
        if self.graphs is None:
            with self._lock:
                self.eager_runs += 1
            return self.raw_dispatch(images, k, t_margin)
        images = np.ascontiguousarray(images, np.float32)
        statics = self._statics_fn(k)
        key = (images.shape[0], images.shape[1:], statics, t_margin)
        with self._lock:
            prog = self.programs.get(key)
            if prog is None:
                prog = self.programs[key] = self._capture(images, statics, t_margin)
            prog.static_in.copy_(torch.from_numpy(images))
            prog.replay()
            for (fn, attr), n in prog.launches.items():
                setattr(fn, attr, getattr(fn, attr) + n)
            prog.replays += 1
            return prog.out

    def _capture(self, images: np.ndarray, statics, t_margin) -> Program:
        static_in = torch.empty(images.shape, dtype=torch.float32, device=self.device)
        static_in.copy_(torch.from_numpy(images))

        def run():
            return self._run(static_in, statics, t_margin)

        t0 = time.perf_counter()
        self.graphs.warm(run)
        self.eager_runs += 1
        t1 = time.perf_counter()
        before = launch_counters()
        replay, out = self.graphs.capture(run)
        after = launch_counters()
        for (fn, attr), n in before.items():  # the capture launched nothing
            setattr(fn, attr, n)
        launches = {key: after[key] - n for key, n in before.items() if after[key] != n}
        t2 = time.perf_counter()
        log.info("captured the dispatch B=%d statics=%s t_margin=%s: warm run %.1f ms, "
                 "capture %.1f ms", images.shape[0], statics, t_margin, (t1 - t0) * 1e3,
                 (t2 - t1) * 1e3)
        return Program(static_in, replay, out, launches, t1 - t0, t2 - t1)

    def __call__(self, images: np.ndarray, k: int):
        with self._lock:
            def retry(t_margin=None):
                return self.dispatch(images, k, t_margin)

            return self._epilogue(retry(), k, retry)


def make_batched_search(prologue: Callable, core: Callable, statics_fn: Callable,
                        epilogue: Callable, device, graphs=None) -> BatchedSearch:
    """Compose ``prologue(images) -> feats`` and ``core(feats, statics,
    t_margin) -> out`` into one dispatch, wrapped by the family's
    ``epilogue(out, k, retry) -> (d, i)``, replayed as CUDA graphs on a
    CUDA device (:class:`BatchedSearch`)."""
    return BatchedSearch(prologue, core, statics_fn, epilogue, device, graphs)


def certificate_epilogue(descending: bool, stats=None, label: str = ""):
    """Exact-search epilogue: one host transfer of (d, i, cert); on a
    certificate failure re-run the dispatch once at the wide margin and
    count the escalation; then pad the Faiss-shaped (-1, worst) tail when k
    exceeds the candidate pool."""

    def epilogue(out, k: int, retry):
        d, i, cert = (t.cpu().numpy() for t in out)
        if not cert.all():
            n_fail = int((~cert).sum())
            log.warning("%stop-k certificate failed for %d queries; "
                        "re-running at wide margin", label, n_fail)
            if stats is not None:
                stats.record_escalation(n_fail)
            d, i, cert2 = (t.cpu().numpy() for t in retry(t_margin=WIDE_MARGIN))
            if not cert2.all():
                n_still = int((~cert2).sum())
                log.error("%stop-k certificate STILL failing for %d queries at "
                          "wide margin %d — serving best-effort results",
                          label, n_still, WIDE_MARGIN)
                if stats is not None:
                    stats.record_escalation(n_still)
        return faiss_tail(d, i, k, descending)

    return epilogue


def cnn_prologue(embedder, normalize: bool):
    """CNN embed prologue: preprocess -> backbone -> optional l2-normalize,
    on the (B, H, W, 3) f32 images already on the embedder's device (the
    dispatch's upload, or a captured program's static input). Images
    arrive resized to the index-build resolution (``wrap_serving``)."""

    def prologue(images: torch.Tensor) -> torch.Tensor:
        emb = embedder.embed(images)
        return l2_normalize(emb) if normalize else emb

    return prologue


def bovw_prologue(descriptor, pipeline, normalize: bool):
    """BoVW prologue on the (B, H, W, 3) images on the device: describe
    (``descriptor.describe_device``) -> spherical normalize -> nearest
    codeword (``ops/kmeans.assign``: the k-means kernel on the card) ->
    histogram -> BM25 (with the corpus's avgdl, as the pipeline's
    transform) -> optional idf -> optional l2-normalize. The codebook, its
    3xTF32 split and the idf go to the device here, once, before any
    capture."""
    from image_search_engine_tpu_torch.ops.bm25 import bm25_transform
    from image_search_engine_tpu_torch.ops.histogram import batched_histograms
    from image_search_engine_tpu_torch.ops.kmeans import assign, centroid_split

    dev = pipeline.kmeans.device  # the engine loads both on its device
    cents = torch.as_tensor(pipeline.kmeans.cluster_centers_, dtype=torch.float32, device=dev)
    split = centroid_split(cents) if dev.type == "cuda" else None
    bm = pipeline.bm25
    idf = (torch.as_tensor(bm.idf_, dtype=torch.float32, device=dev)
           if bm.apply_idf and bm.idf_ is not None else None)
    avgdl = bm.avgdl_ if (bm.use_train_avgdl and bm.avgdl_) else None
    n_clusters, spherical = pipeline.n_clusters, pipeline.spherical

    def prologue(images: torch.Tensor) -> torch.Tensor:
        feats, valid = descriptor.describe_device(images)
        b, kp, dd = feats.shape
        # the assignment kernel reads rows of contiguous columns: DAISY's
        # come out of a permute
        rows = feats.reshape(-1, dd).to(torch.float32).contiguous()
        if spherical:
            rows = l2_normalize(rows)
        codes, _ = assign(rows, cents, split)
        w = bm25_transform(batched_histograms(codes.reshape(b, kp), valid, n_clusters),
                           bm.k1, bm.k2, bm.b, avgdl=avgdl)
        if idf is not None:
            w = w * idf[None, :]
        return l2_normalize(w) if normalize else w

    return prologue


def dhash_prologue():
    """dHash prologue: the (B, 64) 0/1 bits of the (B, H, W, 3) images."""
    from image_search_engine_tpu_torch.ops.dhash import dhash_bits
    from image_search_engine_tpu_torch.ops.image_ops import rgb_to_gray

    def prologue(images: torch.Tensor) -> torch.Tensor:
        return dhash_bits(rgb_to_gray(images)).to(torch.float32)

    return prologue


def dhash_family(bits: np.ndarray, device):
    """dHash search over the (N, 64) bool store: the Hamming distances and
    the k nearest, equal distances in index order (ops/dhash.hamming_topk;
    no kernel, as the JAX package's XLA scan). Returns (core, statics_fn,
    epilogue); the epilogue is one host transfer of (distances int32, ids
    int32)."""
    from image_search_engine_tpu_torch.ops.dhash import hamming_topk

    db = torch.as_tensor(np.asarray(bits, bool), device=device).to(torch.float32)
    n = db.shape[0]

    def core(qbits, k, t_margin):
        del t_margin
        return hamming_topk(qbits, db, k)

    def epilogue(out, k: int, retry):
        del k, retry
        return tuple(t.cpu().numpy() for t in out)

    return core, lambda k: min(k, n), epilogue


def flat_family(index, stats=None, label: str = ""):
    """Exact flat search core: the two-phase kernels for k <= 128 (the int8
    kernels for an int8 store), the plain full scan past that (the
    index/flat.py rule) and for chi2, which has no kernel (elementwise, the
    chunked scan). Emits the certificate either way (the full scan's is True
    by construction). Returns (core, statics_fn, epilogue)."""
    search_metric = "ip" if index.metric in ("ip", "cosine") else index.metric
    store, norms, scales = index.store.vectors, index.store.norms, index.store.scales
    n_valid = index.store.n

    def core(emb, k, t_margin):
        return local_topk_with_norms(
            emb, store, norms, k, search_metric,
            use_kernels=k <= MAX_KERNEL_K and search_metric != "chi2", scales=scales,
            with_certificate=True, t_margin=t_margin)

    epilogue = certificate_epilogue(descending=search_metric == "ip", stats=stats, label=label)
    return core, lambda k: min(k, n_valid), epilogue


def finish_epilogue(index):
    """Probed-family epilogue: one host transfer of (d, i, ok), invalid
    slots to -1, then the index's Faiss-shaped ``_finish`` (k padding,
    cosine conversion). Probed families carry no certificate, so there is
    no retry."""

    def epilogue(out, k: int, retry):
        del retry
        return index._host_finish([out], k)

    return epilogue


def ivf_family(index):
    """Single-device cell-probe: the probed-scan kernel over the resident
    list-contiguous table (ops/ivf.ivf_probed_topk). The JAX package's
    family runs the XLA gather path here; both score the same probes and
    rows, so results agree modulo ties. Returns (core, statics_fn,
    epilogue)."""
    nprobe = index._effective_nprobe()
    bcents, lists, packed, pnorms = index._device_arrays()

    def core(emb, k, t_margin):
        del t_margin
        return ivf_probed_topk(emb, bcents, packed, pnorms, lists, k, nprobe)

    return core, lambda k: index._k_eff(k, nprobe), finish_epilogue(index)


def ivfpq_family(index):
    """Single-device IVF-PQ: the codes are decompressed once, at engine
    start, into a resident bf16 reconstruction table (scanning it is ADC up
    to bf16 rounding), then the probed-scan kernel and the optional exact
    rerank run in the same dispatch. Returns (core, statics_fn, epilogue);
    the statics are (k_eff, rerank shortlist or 0)."""
    from image_search_engine_tpu_torch.index.ivf import _exact_rescore

    nprobe = index._effective_nprobe()
    pool = nprobe * index.lists.shape[1]
    bcents, lists, _, _, _ = index._device_arrays_pq()
    recon, rnorms = index.recon_table()
    rerank = index.rerank
    if rerank and index.vectors is None:
        log.warning("IVFPQ index configured with rerank=%d but the artifact holds codes "
                    "only — serving ADC-ranked results (rebuild with --pq-rerank to keep "
                    "raw vectors)", rerank)
        rerank = 0
    raw = index.vectors if rerank else None

    def core(emb, statics, t_margin):
        del t_margin
        k, c = statics
        out = ivf_probed_topk(emb, bcents, recon, rnorms, lists, c or k, nprobe)
        if c:
            out = _exact_rescore(emb, raw, out[1], out[2], k)
        return out

    def statics_fn(k):
        k_eff = index._k_eff(k, nprobe)
        return k_eff, (min(max(rerank, k_eff), pool) if rerank else 0)

    return core, statics_fn, finish_epilogue(index)


def wrap_serving(engine, batched_search: BatchedSearch, image_size: int, cfg):
    """The per-request ``search(image, k)``: host resize to the index-build
    resolution on the request's thread, then the dispatch on the device
    thread, either per request or, with ``--micro-batch``, through the
    MicroBatcher, whose worker hands each padded batch to the device
    thread. Sets on ``engine`` what prewarm and ``/stats`` read, with the
    JAX package's names: ``_use_batcher``, ``_mb_calibrated``,
    ``_batcher`` (built lazily on the first batched request),
    ``_batcher_lock``, ``_mb_calibrate`` (auto mode) and
    ``_extra_prewarm`` (captures B = ``micro_batch_max``); and
    ``_on_device(fn, *args)``, which runs ``fn`` on the device thread."""
    from image_search_engine_tpu_torch.serving.batching import MicroBatcher
    from image_search_engine_tpu_torch.serving.http import _resize_host

    s = image_size
    # Device work runs on one long-lived thread: PyTorch caches cuDNN
    # execution plans per thread, and the HTTP server starts a thread per
    # request, which would re-plan every convolution each time. Captures
    # and replays run there too.
    device_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")
    engine._device_thread = device_thread

    def on_device(fn, *args):
        return device_thread.submit(fn, *args).result()

    def device_search(images: np.ndarray, k: int):
        return on_device(batched_search, images, k)

    engine._on_device = on_device
    mb_mode = cfg.micro_batch_mode()
    if mb_mode == "off":
        def search(image: np.ndarray, k: int):
            return device_search(_resize_host(image, s)[None], k)

        return search

    if mb_mode == "on":
        log.warning(
            "--micro-batch on: concurrent requests wait up to %.1f ms to share one padded "
            "batch of %d. Independent dispatches also pipeline (the host prepares one "
            "request while the device runs another), so whether coalescing pays depends "
            "on the host; --micro-batch auto measures it at prewarm on this host",
            cfg.micro_batch_wait_ms, cfg.micro_batch_max)
    # "on": trust the flag. "auto": serve per request until prewarm's
    # calibration measures that coalescing beats independent dispatches
    # here; with --no-prewarm nothing measures, so auto stays off, and
    # says so instead of reporting "auto" with no calibration run.
    if mb_mode == "auto" and not cfg.prewarm:
        log.warning(
            "--micro-batch auto needs prewarm to calibrate; with --no-prewarm "
            "calibration never runs and queries serve UNBATCHED (drop --no-prewarm, "
            "or pass --micro-batch on/off explicitly)")
    engine._mb_calibrated = False  # surfaced via /stats ("calibrated")
    engine._use_batcher = mb_mode == "on"
    engine._batcher = None
    engine._batcher_lock = threading.Lock()
    if mb_mode == "auto":
        engine._mb_calibrate = dict(batched_search=device_search, image_shape=(s, s, 3))
    # capture B = micro_batch_max at prewarm too: the first concurrent
    # burst must not pay a capture
    engine._extra_prewarm = lambda k: device_search(
        np.zeros((cfg.micro_batch_max, s, s, 3), np.float32), k)

    def search(image: np.ndarray, k: int):
        if engine._use_batcher:
            if engine._batcher is None:
                with engine._batcher_lock:
                    if engine._batcher is None:
                        engine._batcher = MicroBatcher(
                            device_search, max_batch=cfg.micro_batch_max,
                            max_wait_ms=cfg.micro_batch_wait_ms)
            return engine._batcher.search(_resize_host(image, s), k)
        return device_search(_resize_host(image, s)[None], k)

    return search
