"""Offline indexer CLI: corpus images -> on-disk index artifacts.

Port of the DNN half of ``image_search_engine_tpu/indexer.py``: decode
the corpus in a host thread pool (``utils/imageio.load_images_batched``),
embed it in batches on the device, build a flat, cell-probe (IVF) or IVF-PQ
index and write it as an ``.npz`` in the JAX package's format, with the
``images.csv`` id -> path sidecar, the packed thumbnails and the
``embedder.json`` provenance. BoVW and dHash builds wait for ROADMAP.md
(queue 1 item 5).

Usage:
    python -m image_search_engine_tpu_torch.indexer --data-dir photos/ \\
        --method dnn --index-type ivfpq --pq-rerank 64 --device cuda
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import time
from pathlib import Path

import numpy as np

from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu_torch.utils.imageio import (
    ThumbnailCache, get_image_paths, load_images_batched, load_paths_csv, save_paths_csv)
from image_search_engine_tpu_torch.utils.unported import not_ported

log = logging.getLogger(__name__)

# bump with the JAX package's tag (image_search_engine_tpu/indexer.py): an
# index built under another backbone geometry must be rebuilt
EMBEDDER_ARCH = "conv-pad-v3"
BACKEND = "torch"


def _torch_weights_sha(cfg: Config):
    """sha256 of the backbone checkpoint, or None for random init."""
    if cfg.torch_weights is None:
        return None
    h = hashlib.sha256()
    with open(cfg.torch_weights, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def warn_if_random_backbone(cfg: Config, doing: str) -> bool:
    """Warn (and return True) when the DNN method runs without
    ``--torch-weights``: a random backbone's embeddings carry no
    semantics, where the reference is pretrained by default."""
    if cfg.method != Method.DNN or cfg.torch_weights is not None:
        return False
    log.warning(
        "%s with a RANDOMLY INITIALIZED %s backbone (no --torch-weights): "
        "embeddings carry no semantics and retrieval quality will be near "
        "chance. Pass --torch-weights <torchvision checkpoint.pth>.",
        doing, cfg.dnn_model.value)
    return True


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for what the port does not serve yet."""
    if cfg.method != Method.DNN:
        raise not_ported(f"method {cfg.method.value!r}", "bovw")
    if cfg.index_type == IndexType.CHI2:
        raise not_ported("the chi2 metric", "chi2")
    if cfg.store_dtype == "int8":
        raise not_ported("the int8 store", "int8")
    if cfg.shard_devices is not None or cfg.dcn_coordinator is not None:
        raise not_ported("--sharded / --dcn-*", "multi-device")


def _build_index(cfg: Config, feats: np.ndarray, device):
    """The configured index over ``feats`` (flat, cell-probe or IVF-PQ)."""
    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex

    if cfg.index_type == IndexType.IVFPQ:
        # the reference's "cell-probe" index: m sub-quantizers x 8 bits
        # over coarse residuals
        return IVFPQIndex(metric="l2", nlist=cfg.ivf_nlist, nprobe=cfg.ivf_nprobe,
                          m=cfg.pq_m, rerank=cfg.pq_rerank, device=device).add(feats)
    if cfg.index_type == IndexType.CELL_PROBE:
        return IVFIndex(metric="l2", nlist=cfg.ivf_nlist, nprobe=cfg.ivf_nprobe,
                        table_dtype=cfg.store_dtype, device=device).add(feats)
    return FlatIndex(cfg.index_type.value, dtype=cfg.store_dtype, device=device).add(feats)


def build_dnn_index(cfg: Config, paths, device="cuda", use_native: bool = False) -> None:
    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    warn_if_random_backbone(cfg, "building a DNN index")
    embedder = CNNEmbedder(cfg.dnn_model.value, image_size=cfg.resize_size,
                           batch_size=cfg.embed_batch_size, device=device,
                           torch_weights=cfg.torch_weights)
    feats, kept = [], []
    for batch, idx in load_images_batched(paths, cfg.embed_batch_size,
                                          (cfg.resize_size, cfg.resize_size),
                                          use_native=use_native):
        feats.append(embedder.embed_batch(batch))
        kept.extend(idx)
    if not feats:
        raise SystemExit("no image could be decoded")
    feats = np.concatenate(feats)
    index = _build_index(cfg, feats, device)
    if cfg.index_type == IndexType.IVFPQ:
        # a rerank-enabled artifact carries the raw vectors the rerank scores
        index.save(cfg.dnn_index_path, store_raw=cfg.pq_rerank > 0)
    else:
        index.save(cfg.dnn_index_path)
    save_paths_csv([paths[i] for i in kept], cfg.paths_file)
    _save_embedder_provenance(cfg)
    log.info("DNN index: %d vectors (%d-D) -> %s", len(kept), feats.shape[1],
             cfg.dnn_index_path)


def _save_embedder_provenance(cfg: Config) -> None:
    """embedder.json: what produced the stored embeddings (the JAX
    package's keys plus ``backend``), checked by the engine at start."""
    sha = _torch_weights_sha(cfg)
    (cfg.artifacts_dir / "embedder.json").write_text(json.dumps({
        "model": cfg.dnn_model.value,
        "resize_size": cfg.resize_size,
        "arch": EMBEDDER_ARCH,
        "weights": "random" if sha is None else f"torch:{sha}",
        "torch_weights_sha256": sha,
        "backend": BACKEND,
    }))


def build_thumbnails(cfg: Config) -> None:
    """Pack result thumbnails once at index time."""
    kept_paths = load_paths_csv(cfg.paths_file)
    t0 = time.time()
    ThumbnailCache.build(kept_paths, cfg.thumbnails_path, cfg.thumbnail_size)
    log.info("thumbnail cache: %d thumbs -> %s (%.1fs)", len(kept_paths),
             cfg.thumbnails_path, time.time() - t0)


def main(cfg: Config, device="cuda", use_native: bool = False) -> None:
    check_supported(cfg)
    t0 = time.time()
    cfg.artifacts_dir.mkdir(parents=True, exist_ok=True)
    paths = get_image_paths(cfg.data_dir)
    if not paths:
        raise SystemExit(f"no images found under {cfg.data_dir}")
    log.info("indexing %d images with method=%s", len(paths), cfg.method.value)
    build_dnn_index(cfg, paths, device, use_native)
    if cfg.precompute_thumbnails:
        build_thumbnails(cfg)
    log.info("index build finished in %.1fs", time.time() - t0)


def parse_args(argv=None):
    """-> (Config, device, use_native)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", type=Path, required=True)
    ap.add_argument("--artifacts-dir", type=Path, default=Path("artifacts"))
    ap.add_argument("--method", choices=[m.value for m in Method], default="dnn")
    ap.add_argument("--index-type", choices=[t.value for t in IndexType], default="l2")
    ap.add_argument("--dnn-model", choices=[m.value for m in DnnModel], default="resnet50")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--resize-size", type=int, default=224)
    ap.add_argument("--torch-weights", type=Path, default=None,
                    help="torchvision ResNet .pth checkpoint to load as the backbone")
    ap.add_argument("--store-dtype", choices=["f32", "bf16", "int8"], default="f32",
                    help="flat-store / cell-probe table precision (int8 is not "
                         "ported yet)")
    ap.add_argument("--pq-rerank", type=int, default=0,
                    help="ivfpq only: exact-rerank shortlist size (0 = ADC "
                         "ranking; >0 stores raw vectors in the artifact and "
                         "re-scores the top-C ADC shortlist exactly)")
    ap.add_argument("--ivf-nlist", type=int, default=8,
                    help="cell-probe/ivfpq coarse cells (reference "
                         "ncentroids=8)")
    ap.add_argument("--ivf-nprobe", type=int, default=5,
                    help="cells probed per query (reference nprobe=5)")
    ap.add_argument("--pq-m", type=int, default=16,
                    help="ivfpq subquantizers (reference m=16)")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode+resize with the C++ loader (native/)")
    ap.add_argument("--no-thumbnails", action="store_true",
                    help="skip the packed thumbnail cache (thumbnails.npz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    a = ap.parse_args(argv)
    cfg = Config(
        data_dir=a.data_dir, artifacts_dir=a.artifacts_dir, method=Method(a.method),
        index_type=IndexType(a.index_type), dnn_model=DnnModel(a.dnn_model),
        embed_batch_size=a.batch_size, resize_size=a.resize_size,
        precompute_thumbnails=not a.no_thumbnails, store_dtype=a.store_dtype,
        torch_weights=a.torch_weights, pq_rerank=a.pq_rerank, ivf_nlist=a.ivf_nlist,
        ivf_nprobe=a.ivf_nprobe, pq_m=a.pq_m)
    return cfg, a.device, a.native_loader


def cli_main(argv=None) -> None:
    """``python -m image_search_engine_tpu_torch.indexer`` body."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg, device, use_native = parse_args(argv)
    main(cfg, device, use_native)


if __name__ == "__main__":
    cli_main()
