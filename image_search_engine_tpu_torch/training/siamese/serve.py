"""Serve a trained siamese index over the engine's HTTP contract.

Port of ``image_search_engine_tpu/training/siamese/serve.py``: load the
latest (or a named) checkpoint and the ``create_index`` artifacts (the
flat-IP ``.npz`` and ``images.csv``, built by either package), and answer
``POST /similar_images`` with the same ``{"prediction": [[similarity,
b64_thumb, path], ...]}`` payload (cosine similarity, descending) through
the port's HTTP handler (``serving/http.make_handler``). The server is the
port's ``engine.QueryHTTPServer`` (a listen backlog of 1024, where the JAX
package's ``ThreadingHTTPServer`` keeps socketserver's 5). Each query
embeds and searches eagerly, as the JAX package's does, on one long-lived
device thread (cuDNN plans its convolutions once per thread).

    python -m image_search_engine_tpu_torch.training.siamese.serve \\
        --ckpt-dir artifacts/siamese_ckpts \\
        --index artifacts/siamese.index.npz \\
        --images-csv artifacts/siamese_images.csv --port 5001 [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import logging
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


class SiameseQueryEngine:
    """Image -> ranked (similarity, b64 thumb, path) through the trained
    embedding net + flat-IP index on ``device``. Duck-typed to what
    ``serving/http.make_handler`` needs (query / paths / stats / cfg)."""

    def __init__(self, cfg, index_path, images_csv,
                 checkpoint: Optional[Path] = None, n_results: int = 9,
                 prewarm: bool = True, device="cuda"):
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.training.siamese.config import get_latest_checkpoint
        from image_search_engine_tpu_torch.training.siamese.train import Trainer
        from image_search_engine_tpu_torch.utils.imageio import load_paths_csv
        from image_search_engine_tpu_torch.utils.profiling import ServingStats

        self.scfg = cfg
        self.trainer = Trainer(cfg, device=device)
        ckpt = checkpoint or get_latest_checkpoint(cfg.ckpt_dir)
        if ckpt is not None:
            self.trainer.load_checkpoint(ckpt)
            log.info("serving with checkpoint %s", Path(ckpt).name)
        else:
            log.warning(
                "no checkpoint in %s — serving with RANDOM weights; "
                "rankings will be near chance (train first, or pass "
                "--checkpoint)", cfg.ckpt_dir)
        self.index = FlatIndex.load(index_path, device=self.trainer.device)
        self.paths: List[str] = [str(p) for p in load_paths_csv(images_csv)]
        if self.index.ntotal != len(self.paths):
            log.warning(
                "index holds %d rows but images.csv lists %d paths — "
                "artifacts out of sync (rebuild with create_index)",
                self.index.ntotal, len(self.paths))
        self.stats = ServingStats()
        # make_handler reads these off the engine object
        self.cfg = SimpleNamespace(
            num_images_to_return=n_results, thumbnail_size=256,
            micro_batch_mode=lambda: "off")
        self._device_thread = cf.ThreadPoolExecutor(1, thread_name_prefix="siamese-device")
        if prewarm:
            t0 = time.time()
            h, w = cfg.image_size
            self._search(np.zeros((h, w, 3), np.float32), n_results)
            log.info("prewarm finished in %.1fs", time.time() - t0)

    def _embed(self, image: np.ndarray) -> np.ndarray:
        from PIL import Image as _Image

        h, w = self.scfg.image_size
        if image.shape[:2] != (h, w):
            im = _Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
            image = np.asarray(im.resize((w, h), _Image.BILINEAR), np.float32) / 255.0
        emb = self.trainer.embed(image[None].astype(np.float32), batch_size=self.scfg.batch_size)
        return emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)

    def _search(self, image: np.ndarray, k: int):
        """Embed and search on the device thread."""
        return self._device_thread.submit(
            lambda: self.index.search(self._embed(image), k)).result()

    def query(self, image: np.ndarray, k: Optional[int] = None) -> List[Tuple[float, str, str]]:
        from image_search_engine_tpu_torch.utils.imageio import thumbnail_b64

        k = k or self.cfg.num_images_to_return
        t0 = time.time()
        try:
            d, i = self._search(image, k)
        except Exception:
            self.stats.record(time.time() - t0, error=True)
            raise
        self.stats.record(time.time() - t0)
        out = []
        for dist, idx in zip(d[0].tolist(), i[0].tolist()):
            if idx < 0 or idx >= len(self.paths):
                continue
            try:
                thumb = thumbnail_b64(self.paths[idx], self.cfg.thumbnail_size)
            except Exception:  # noqa: BLE001 — missing corpus file
                thumb = ""
            out.append((round(float(dist), 4), thumb, self.paths[idx]))
        return out

    def close(self) -> None:
        self._device_thread.shutdown(wait=True)


def make_server(engine: SiameseQueryEngine, host: str, port: int):
    """The port's ``QueryHTTPServer`` (listen backlog 1024) on ``engine``."""
    from image_search_engine_tpu_torch.engine import QueryHTTPServer
    from image_search_engine_tpu_torch.serving.http import make_handler

    return QueryHTTPServer((host, port), make_handler(engine))


def serve(engine: SiameseQueryEngine, host: str, port: int) -> None:
    httpd = make_server(engine, host, port)
    log.info("serving siamese index on http://%s:%d (corpus: %d images, device %s)",
             host, httpd.server_address[1], len(engine.paths), engine.trainer.device)
    try:
        with httpd:
            httpd.serve_forever()
    finally:
        engine.close()


def main(argv=None) -> None:
    from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", type=Path, default=Path("artifacts/siamese_ckpts"))
    ap.add_argument("--checkpoint", type=Path, default=None,
                    help="specific checkpoint (default: latest epoch)")
    ap.add_argument("--index", type=Path, default=Path("artifacts/siamese.index.npz"))
    ap.add_argument("--images-csv", type=Path, default=Path("artifacts/siamese_images.csv"))
    ap.add_argument("--backbone", default="densenet121")
    ap.add_argument("--image-size", type=int, nargs=2, default=(352, 256),
                    metavar=("H", "W"))
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--n-results", type=int, default=9)  # the reference's N_RESULTS
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--no-prewarm", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the card) or cpu")
    a = ap.parse_args(argv)
    cfg = SiameseConfig(ckpt_dir=a.ckpt_dir, backbone=a.backbone,
                        image_size=tuple(a.image_size), embedding_dim=a.embedding_dim)
    engine = SiameseQueryEngine(cfg, a.index, a.images_csv, checkpoint=a.checkpoint,
                                n_results=a.n_results, prewarm=not a.no_prewarm,
                                device=a.device)
    serve(engine, a.host, a.port)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
