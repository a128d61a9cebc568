"""Query engine: HTTP serving of a DNN index on a torch device.

Port of the single-device DNN part of ``image_search_engine_tpu/engine.py``
for flat, cell-probe (IVF) and IVF-PQ indexes. The HTTP contract is the JAX
package's (serving/http.py): ``POST /similar_images`` takes a multipart
image upload and answers ``{"prediction": [[distance, base64_thumbnail,
path], ...]}``; ``GET /healthz``, ``GET /stats`` and the upload UI at ``GET
/`` come with it. Per request: host decode and resize, then one device
dispatch (embed + the index family's search core, serving/fused.py), then
thumbnails from the packed cache. BoVW, dHash, micro-batched and sharded
serving wait for ROADMAP.md.

Usage:
    python -m image_search_engine_tpu_torch.engine --artifacts-dir artifacts \\
        --device cuda --port 5000
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

from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu_torch.serving.http import make_handler
from image_search_engine_tpu_torch.utils.imageio import ThumbnailCache, load_paths_csv, thumbnail_b64
from image_search_engine_tpu_torch.utils.profiling import ServingStats
from image_search_engine_tpu_torch.indexer import (
    BACKEND, EMBEDDER_ARCH, _torch_weights_sha, check_supported, warn_if_random_backbone)
from image_search_engine_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

Prediction = List[Tuple[float, str, str]]  # (distance, b64 thumb, path)


class QueryEngine:
    """Image -> ranked (distance, thumbnail, path) results."""

    def __init__(self, cfg: Config, device="cuda", prewarm: bool = True):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self._search = self._build(cfg)
        if prewarm:
            self.prewarm()

    def prewarm(self) -> None:
        """One search on a blank image before the first request: loads the
        kernel library (building it on first use) and warms cuDNN. Errors
        propagate: a kernel that cannot build or launch stops the start."""
        t0 = time.time()
        dummy = np.zeros((self.cfg.resize_size, self.cfg.resize_size, 3), np.float32)
        self._search(dummy, min(self.cfg.num_images_to_return, self.index.ntotal))
        log.info("prewarm finished in %.1fs", time.time() - t0)

    def _build(self, cfg: Config) -> Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]:
        from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
        from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
        from image_search_engine_tpu_torch.serving import fused

        self._check_embedder_provenance(cfg)
        warn_if_random_backbone(cfg, "serving queries")
        embedder = CNNEmbedder(cfg.dnn_model.value, image_size=cfg.resize_size,
                               batch_size=1, device=self.device,
                               torch_weights=cfg.torch_weights)
        self.index = self._load_index(cfg.dnn_index_path, cfg, self.device)
        prologue = fused.cnn_prologue(embedder, normalize=self.index.metric == "cosine")
        if type(self.index) is IVFPQIndex:
            family = fused.ivfpq_family(self.index)
        elif type(self.index) is IVFIndex:
            family = fused.ivf_family(self.index)
        else:
            family = fused.flat_family(self.index, stats=self.stats)
        batched = fused.make_batched_search(prologue, *family)
        return fused.wrap_serving(batched, cfg.resize_size, cfg)

    @staticmethod
    def _load_index(path, cfg: Config, device):
        """The index the config names, loaded onto ``device``."""
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex

        if cfg.index_type == IndexType.IVFPQ:
            return IVFPQIndex.load(path, device=device)
        if cfg.index_type == IndexType.CELL_PROBE:
            return IVFIndex.load(path, device=device)
        return FlatIndex.load(path, device=device)

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


def make_server(cfg: Config, device="cuda", prewarm: Optional[bool] = None):
    """(engine, ThreadingHTTPServer bound to cfg.host:cfg.port)."""
    prewarm = cfg.prewarm if prewarm is None else prewarm
    engine = QueryEngine(cfg, device=device, prewarm=prewarm)
    return engine, ThreadingHTTPServer((cfg.host, cfg.port), make_handler(engine))


def serve(cfg: Config, device="cuda", prewarm: Optional[bool] = None) -> None:
    engine, httpd = make_server(cfg, device, prewarm)
    log.info("serving %s on http://%s:%d (corpus: %d images, device %s)",
             cfg.method.value, cfg.host, httpd.server_address[1], len(engine.paths),
             engine.device)
    with httpd:
        httpd.serve_forever()


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
                    help="torchvision ResNet .pth to load as the backbone "
                         "(must match the indexer's)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the startup search that builds and loads the kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    a = ap.parse_args(argv)
    cfg = Config(
        artifacts_dir=a.artifacts_dir, method=Method(a.method),
        index_type=IndexType(a.index_type), dnn_model=DnnModel(a.dnn_model),
        host=a.host, port=a.port, resize_size=a.resize_size,
        torch_weights=a.torch_weights,
        prewarm=not a.no_prewarm)
    return cfg, a.device


def cli_main(argv=None) -> None:
    """``python -m image_search_engine_tpu_torch.engine`` body."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg, device = parse_args(argv)
    serve(cfg, device)


if __name__ == "__main__":
    cli_main()
