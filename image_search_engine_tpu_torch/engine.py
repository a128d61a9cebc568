"""Query engine: HTTP serving of an index on a torch device.

Port of the single-device part of ``image_search_engine_tpu/engine.py``:
the dnn method over flat (l2, cosine or chi2; f32, bf16 or int8 store, as
the index file says), cell-probe (IVF) and IVF-PQ indexes; the bovw method
(the descriptor the pipeline artifact names, its codebook and BM25, then
the flat index over the histograms); the dhash method (a Hamming scan of
the stored bits). The HTTP contract is the JAX
package's (serving/http.py): ``POST /similar_images`` takes a multipart
image upload and answers ``{"prediction": [[distance, base64_thumbnail,
path], ...]}``; ``GET /healthz``, ``GET /stats`` and the upload UI at ``GET
/`` come with it. Per request: host decode and resize, then one device
dispatch (the method's prologue + the index family's search core,
serving/fused.py; on a CUDA device a CUDA graph captured at prewarm and
replayed), then thumbnails from the packed cache. ``--micro-batch
on|auto`` coalesces concurrent requests into one padded batch
(serving/batching.py). ``--sharded`` serves the index row-sharded over a
mesh of local devices (parallel/), and ``--dcn-*`` over several
processes: process 0 serves HTTP and broadcasts each dispatch to the
others (serving/multihost.py).

Usage:
    python -m image_search_engine_tpu_torch.engine --artifacts-dir artifacts \\
        --device cuda --port 5000 [--micro-batch [off|on|auto]] [--prewarm-wide-margin] \\
        [--sharded [N]] [--dcn-coordinator HOST:PORT --dcn-processes P --dcn-process-id I]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

from image_search_engine_tpu_torch.config import (
    Config, CornerDescriptorKind, DnnModel, IndexType, Method)
from image_search_engine_tpu_torch.serving.http import make_handler
from image_search_engine_tpu_torch.utils.imageio import ThumbnailCache, load_paths_csv, thumbnail_b64
from image_search_engine_tpu_torch.utils.profiling import ServingStats
from image_search_engine_tpu_torch.indexer import (
    BACKEND, EMBEDDER_ARCH, _torch_weights_sha, warn_if_random_backbone)
from image_search_engine_tpu_torch.utils.device import resolve_device, same_device

log = logging.getLogger(__name__)

Prediction = List[Tuple[float, str, str]]  # (distance, b64 thumb, path)


class QueryEngine:
    """Image -> ranked (distance, thumbnail, path) results; with a ``mesh``
    (parallel/mesh.py) the index is served row-sharded over it, and the
    backbone stays on ``device``."""

    def __init__(self, cfg: Config, device="cuda", mesh=None, prewarm: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.paths = load_paths_csv(cfg.paths_file)
        self.stats = ServingStats()
        self.thumbs = None
        if cfg.thumbnails_path.exists():
            cache = ThumbnailCache.load(cfg.thumbnails_path)
            if len(cache) == len(self.paths):
                self.thumbs = cache
            else:
                log.warning("thumbnail cache has %d entries for %d paths; ignoring "
                            "(rebuild the index)", len(cache), len(self.paths))
        # set by serving/fused.wrap_serving (micro-batching), read by
        # prewarm and /stats
        self._extra_prewarm = None
        self._mb_calibrate = None
        self._use_batcher = False
        self._mb_calibrated = False
        self._batcher = None
        self.mb_calibration = None  # the auto calibration's figures, once it ran
        # multi-process serving (serving/multihost.py): the coordinator, and
        # the served dispatch without its broadcast, which workers run
        self._mh_coordinator = None
        self._fused_raw = None
        self._search = self._build(cfg)
        if prewarm:
            self.prewarm()

    def prewarm(self) -> None:
        """Capture the serving programs before the first request: B = 1 at
        the default k, B = ``micro_batch_max`` when batching is not off, and
        the certificate's wide-margin retry with ``--prewarm-wide-margin``;
        on a CUDA device each first call builds and loads the kernel
        library, warms cuDNN, and captures the dispatch as a CUDA graph.
        Then one timed warm search, and the ``--micro-batch auto``
        calibration.

        Errors propagate, unlike the JAX engine, which logs a failed
        prewarm or calibration and serves on: here a kernel that cannot
        build or launch, a dispatch that cannot be captured, or a failed
        calibration (whose programs have all run by then, so its failure
        is a kernel or capture fault) stops the start."""
        from image_search_engine_tpu_torch.index.flat import WIDE_MARGIN

        t0 = time.time()
        dummy = np.zeros((self.cfg.resize_size, self.cfg.resize_size, 3), np.float32)
        # the real default k, so the program matches the first request's
        # (another k is another program)
        k_warm = min(self.cfg.num_images_to_return, self._index_n)
        self._search(dummy, k_warm)
        if self._extra_prewarm is not None:
            self._extra_prewarm(k_warm)
        if self.cfg.prewarm_wide:
            # t_margin keys its own program: without this, the first
            # certificate escalation captures inside the request path
            self._on_device(self._batched_search.dispatch, dummy[None], k_warm, WIDE_MARGIN)
            log.info("prewarmed the wide-margin (%d) escalation program", WIDE_MARGIN)
        t1 = time.time()
        self._search(dummy, k_warm)
        progs = self._batched_search.programs.values()
        log.info("prewarm finished in %.1fs: %d captured programs (eager warm runs %.1f ms, "
                 "captures %.1f ms); first warm search %.1f ms", t1 - t0, len(progs),
                 sum(p.warm_s for p in progs) * 1e3, sum(p.capture_s for p in progs) * 1e3,
                 (time.time() - t1) * 1e3)
        self._calibrate_micro_batch(k_warm)

    def _calibrate_micro_batch(self, k_warm: int) -> None:
        """``--micro-batch auto``: both programs are warm after prewarm, so
        time independent B = 1 dispatches against one padded batch on this
        host and route by the numbers (serving/batching.py)."""
        calib = self._mb_calibrate
        if calib is None:
            return
        from image_search_engine_tpu_torch.serving import batching

        threaded_ms, batched_ms = batching.measure_micro_batch_gain(
            calib["batched_search"], calib["image_shape"], k_warm, self.cfg.micro_batch_max)
        self._use_batcher = batching.micro_batch_pays(threaded_ms, batched_ms)
        self._mb_calibrated = True
        self.mb_calibration = {"threaded_ms_per_query": threaded_ms,
                               "batched_ms_per_query": batched_ms,
                               "batching": self._use_batcher}
        log.info("micro-batch auto-calibration: %.3f ms/query independent dispatches vs "
                 "%.3f ms/query coalesced (B=%d) -> batching %s", threaded_ms, batched_ms,
                 self.cfg.micro_batch_max, "ON" if self._use_batcher else "OFF")

    def close(self) -> None:
        """Stop the micro-batcher's worker and the device thread."""
        if self._batcher is not None:
            self._batcher.close()
        self._device_thread.shutdown(wait=True)

    def _build(self, cfg: Config) -> Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]:
        """The method's serving dispatch; sets ``index`` (None for dhash),
        ``_index_n`` (the rows served) and ``_batched_search``."""
        build = {Method.DNN: self._build_dnn, Method.BOVW: self._build_bovw,
                 Method.DHASH: self._build_dhash}[cfg.method]
        prologue, family, size = build(cfg)
        from image_search_engine_tpu_torch.serving import fused

        mesh = self.mesh if self.index is not None else None  # dhash never shards
        capture = mesh is None or (mesh.one_device and same_device(mesh.home, self.device))
        if not capture:
            log.info("the mesh's shards span several devices: dispatches run uncaptured")
        self._batched_search = fused.make_batched_search(
            prologue, *family, device=self.device, capture=capture,
            across=fused.across_processes(self.index),
            coordinator=self._make_coordinator(cfg, size, mesh))
        self._fused_raw = self._batched_search.run
        return fused.wrap_serving(self, self._batched_search, size, cfg)

    def _make_coordinator(self, cfg: Config, image_size: int, mesh):
        """The broadcast coordinator (serving/multihost.py) when the mesh
        spans processes: a query landing on this process's HTTP server must
        reach every process's part of the search. None otherwise."""
        if mesh is None or mesh.world <= 1:
            return None
        from image_search_engine_tpu_torch.serving.multihost import MultihostCoordinator

        bmax = cfg.micro_batch_max if cfg.micro_batch_mode() != "off" else 1
        self._mh_coordinator = MultihostCoordinator(bmax, image_size)
        log.info("multi-host serving: %d processes, broadcast shape (%d, %d, %d, 3)",
                 mesh.world, bmax, image_size, image_size)
        return self._mh_coordinator

    @staticmethod
    def _require_fused_for_multihost(mesh, what: str) -> None:
        """Paths without a broadcast hook would leave the workers out of the
        search (a hang, not an error): refuse them on a mesh over
        processes."""
        if mesh is not None and mesh.world > 1:
            raise RuntimeError(
                f"multi-host serving supports fused index families only; "
                f"{what} has no broadcast-dispatch path. Serve it "
                f"single-host (drop --dcn-*).")

    def _build_bovw(self, cfg: Config):
        """Rebuild the descriptor the pipeline artifact records (another
        descriptor family would be a shape error), at the image size the
        index was built with; then the flat family over the histograms."""
        from image_search_engine_tpu_torch.bovw.pipeline import BoVWPipeline
        from image_search_engine_tpu_torch.descriptors import make_descriptor
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.serving import fused

        pipeline = BoVWPipeline.load(cfg.bovw_pipeline_path, device=self.device)
        size = cfg.resize_size
        art_cfg = cfg
        if pipeline.descriptor_kind:
            dp = pipeline.descriptor_params or {}
            art_cfg = Config(
                method=Method.BOVW,
                corner_descriptor=CornerDescriptorKind(pipeline.descriptor_kind),
                max_descriptors_per_image=int(dp.get("max_keypoints", 256)),
                daisy_step=int(dp.get("daisy_step", 32)),
                daisy_radius=int(dp.get("daisy_radius", 32)),
                # an artifact without a pyramid depth predates the pyramid:
                # single-scale, the geometry that built its codebook
                corner_n_levels=int(dp.get("n_levels", 1)),
                corner_scale_step=float(dp.get("scale_step", 1.25)))
            size = int(dp.get("resize_size", cfg.resize_size))
        descriptor = make_descriptor(art_cfg, device=self.device)
        if not hasattr(descriptor, "describe_device"):
            self._require_fused_for_multihost(
                self.mesh, f"descriptor {type(descriptor).__name__} (host-only)")
        self.index = FlatIndex.load(cfg.bovw_index_path, device=self.device, mesh=self.mesh)
        self._index_n = max(1, self.index.ntotal)
        prologue = fused.bovw_prologue(descriptor, pipeline,
                                       normalize=self.index.metric == "cosine")
        return prologue, fused.flat_family(self.index, stats=self.stats, label="BoVW "), size

    def _build_dhash(self, cfg: Config):
        from image_search_engine_tpu_torch.serving import fused

        # dhash never shards (64-bit hashes fit anywhere); a worker would
        # wait in a loop no dispatch ever feeds
        self._require_fused_for_multihost(self.mesh, "method dhash")
        bits = np.load(cfg.dhash_store_path, allow_pickle=False)["bits"]
        self.index = None
        self._index_n = max(1, bits.shape[0])
        return fused.dhash_prologue(), fused.dhash_family(bits, self.device), cfg.resize_size

    def _build_dnn(self, cfg: Config):
        from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
        from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
        from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ
        from image_search_engine_tpu_torch.serving import fused

        self._check_embedder_provenance(cfg)
        warn_if_random_backbone(cfg, "serving queries")
        # the mesh shards the index; a serving batch is too small to split,
        # so the backbone runs on one device
        self.embedder = CNNEmbedder(cfg.dnn_model.value, image_size=cfg.resize_size,
                                    batch_size=1, device=self.device,
                                    torch_weights=cfg.torch_weights)
        self.index = self._load_index(cfg.dnn_index_path, cfg, self.device, self.mesh)
        self._index_n = max(1, self.index.ntotal)
        prologue = fused.cnn_prologue(self.embedder, normalize=self.index.metric == "cosine")
        if isinstance(self.index, ShardedIVFPQ):  # a ShardedIVF too: first
            family = fused.sharded_ivfpq_family(self.index)
        elif isinstance(self.index, ShardedIVF):
            family = fused.sharded_ivf_family(self.index)
        elif type(self.index) is IVFPQIndex:
            family = fused.ivfpq_family(self.index)
        elif type(self.index) is IVFIndex:
            family = fused.ivf_family(self.index)
        else:
            family = fused.flat_family(self.index, stats=self.stats)
        return prologue, family, cfg.resize_size

    @staticmethod
    def _load_index(path, cfg: Config, device, mesh=None):
        """The index the config names, loaded onto ``device``, or resharded
        over ``mesh``: IVF-PQ keeps its compression (per-shard packed codes,
        and the shard-local exact rerank when the artifact has raw rows),
        cell-probe rebuilds per-shard buckets from its raw rows, flat
        shards its store."""
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
        from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ

        if cfg.index_type == IndexType.IVFPQ:
            index = IVFPQIndex.load(path, device=device, mesh=mesh)
            return index if mesh is None else ShardedIVFPQ.from_index(index, mesh)
        if cfg.index_type == IndexType.CELL_PROBE:
            index = IVFIndex.load(path, device=device, mesh=mesh)
            if mesh is None:
                return index
            return ShardedIVF.from_components(index.vectors, index.centroids, index.nprobe,
                                              mesh, metric=index.metric,
                                              table_dtype=index.table_dtype)
        return FlatIndex.load(path, device=device, mesh=mesh)

    @staticmethod
    def _check_embedder_provenance(cfg: Config) -> None:
        """Warn when this process's backbone differs from the one that
        built the index (embedder.json): rankings would be silently wrong."""
        meta_path = cfg.artifacts_dir / "embedder.json"
        if not meta_path.exists():
            log.warning("no embedder.json in %s — cannot check that the index "
                        "was built with this backbone (arch tag %r)",
                        cfg.artifacts_dir, EMBEDDER_ARCH)
            return
        try:
            meta = json.loads(meta_path.read_text())
        except (OSError, json.JSONDecodeError):
            return
        try:
            sha = _torch_weights_sha(cfg)
        except OSError:
            sha = None
        mismatches = []
        if meta.get("model") != cfg.dnn_model.value:
            mismatches.append(f"model {meta.get('model')} vs {cfg.dnn_model.value}")
        if meta.get("resize_size") != cfg.resize_size:
            mismatches.append(f"resize_size {meta.get('resize_size')} vs {cfg.resize_size}")
        if meta.get("arch") != EMBEDDER_ARCH:
            mismatches.append(f"arch {meta.get('arch')} vs {EMBEDDER_ARCH} (rebuild the index)")
        if meta.get("torch_weights_sha256") != sha:
            mismatches.append("torch weights differ from the index build's")
        elif sha is None and meta.get("backend") != BACKEND:
            # each package draws a random backbone its own way
            mismatches.append(
                f"random backbone drawn by backend {meta.get('backend', 'jax')!r}, "
                f"serving with {BACKEND!r}")
        if mismatches:
            log.warning("embedder mismatch vs index build (%s) — query embeddings "
                        "will not live in the stored index's space; results will be "
                        "unreliable. Rebuild the index or match the flags.",
                        "; ".join(mismatches))

    def query(self, image: np.ndarray, k: Optional[int] = None) -> Prediction:
        k = k or self.cfg.num_images_to_return
        t0 = time.time()
        try:
            dists, ids = self._search(image, k)
        except Exception:
            self.stats.record(time.time() - t0, error=True)
            raise
        search_s = time.time() - t0
        self.stats.record(search_s)
        out: Prediction = []
        for dist, idx in zip(dists[0].tolist(), ids[0].tolist()):
            if idx < 0 or idx >= len(self.paths):
                continue
            path = self.paths[idx]
            if self.thumbs is not None:
                thumb = self.thumbs.get_b64(idx)
            else:
                try:
                    thumb = thumbnail_b64(path, self.cfg.thumbnail_size)
                except (OSError, ValueError):  # missing or corrupt corpus file
                    thumb = ""
            out.append((round(float(dist), 4), thumb, path))
        log.info("query: search %.1fms, total %.1fms, %d hits",
                 search_s * 1e3, (time.time() - t0) * 1e3, len(out))
        return out


class QueryHTTPServer(ThreadingHTTPServer):
    """The query server: a thread per connection, and a listen backlog
    that holds a burst of concurrent clients. At socketserver's default
    backlog of 5, the connections that arrive while the accept thread
    waits for the interpreter lock overflow the kernel's queue: their
    handshakes are dropped and retried a second later, or reset."""

    request_queue_size = 1024


def make_server(cfg: Config, device="cuda", prewarm: Optional[bool] = None, mesh=None):
    """(engine, QueryHTTPServer bound to cfg.host:cfg.port)."""
    prewarm = cfg.prewarm if prewarm is None else prewarm
    engine = QueryEngine(cfg, device=device, mesh=mesh, prewarm=prewarm)
    return engine, QueryHTTPServer((cfg.host, cfg.port), make_handler(engine))


def serve(cfg: Config, device="cuda", prewarm: Optional[bool] = None, mesh=None) -> None:
    """Serve HTTP on cfg.host:cfg.port until stopped. The mesh comes from
    ``--sharded`` / ``--dcn-*`` unless given; on a mesh over processes,
    processes > 0 build the same engine without prewarm and follow process
    0's dispatches (serving/multihost.worker_loop) instead of serving
    HTTP, and process 0 releases them when it stops."""
    if mesh is None:
        from image_search_engine_tpu_torch.parallel.mesh import mesh_from_config

        mesh = mesh_from_config(cfg, device)
        if mesh is not None:
            log.info("sharded serving over a %d-shard mesh", mesh.size)
    multihost = mesh is not None and mesh.world > 1
    if multihost and mesh.rank != 0:
        from image_search_engine_tpu_torch.serving.multihost import worker_loop

        engine = QueryEngine(cfg, device=device, mesh=mesh, prewarm=False)
        try:
            worker_loop(engine)
        finally:
            engine.close()
        return
    engine, httpd = make_server(cfg, device, prewarm, mesh)
    log.info("serving %s on http://%s:%d (corpus: %d images, device %s, micro-batch %s)",
             cfg.method.value, cfg.host, httpd.server_address[1], len(engine.paths),
             engine.device, cfg.micro_batch_mode())
    try:
        with httpd:
            httpd.serve_forever()
    finally:
        if engine._mh_coordinator is not None:  # release the workers from their loop
            with engine._mh_coordinator.lock:
                engine._mh_coordinator.shutdown()
        engine.close()


def parse_args(argv=None):
    """-> (Config, device)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifacts-dir", type=Path, default=Path("artifacts"))
    ap.add_argument("--method", choices=[m.value for m in Method], default="dnn")
    ap.add_argument("--index-type", choices=[t.value for t in IndexType], default="l2")
    ap.add_argument("--dnn-model", choices=[m.value for m in DnnModel], default="resnet50")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--resize-size", type=int, default=224)
    ap.add_argument("--torch-weights", type=Path, default=None,
                    help="backbone checkpoint (torchvision ResNet / DenseNet, HF "
                         "BiT) to load; must match the indexer's")
    ap.add_argument("--micro-batch", nargs="?", const="on", default="off",
                    choices=["off", "on", "auto"],
                    help="batch concurrent queries into one device call; 'auto' measures "
                         "at prewarm whether coalescing beats independent dispatches on "
                         "this host and decides from the numbers (bare --micro-batch = "
                         "'on')")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the startup searches that build and load the kernels and "
                         "capture the serving programs (the first request does it then)")
    ap.add_argument("--prewarm-wide-margin", action="store_true",
                    help="also capture the wide-margin program the exactness "
                         "certificate's escalation retries with (otherwise the first "
                         "escalation captures it inside the request path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    from image_search_engine_tpu_torch.utils.cli import add_scaleout_args, apply_scaleout_args

    add_scaleout_args(ap, verb="serve")
    a = ap.parse_args(argv)
    cfg = Config(
        artifacts_dir=a.artifacts_dir, method=Method(a.method),
        index_type=IndexType(a.index_type), dnn_model=DnnModel(a.dnn_model),
        host=a.host, port=a.port, resize_size=a.resize_size,
        micro_batch=a.micro_batch, torch_weights=a.torch_weights,
        prewarm=not a.no_prewarm, prewarm_wide=a.prewarm_wide_margin,
        **apply_scaleout_args(a))
    return cfg, a.device


def cli_main(argv=None) -> None:
    """``python -m image_search_engine_tpu_torch.engine`` body. An interrupt
    (SIGINT) stops the server cleanly: on a mesh over processes process 0
    releases the workers first, and every process exits 0."""
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg, device = parse_args(argv)
    try:
        serve(cfg, device)
    except KeyboardInterrupt:
        log.info("interrupted: server stopped")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli_main()
