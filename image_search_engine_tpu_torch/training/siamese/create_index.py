"""Build a search index from a trained siamese checkpoint.

Port of ``image_search_engine_tpu/training/siamese/create_index.py``: the
one-head net embeds the corpus in batches on the device, the rows are
L2-normalized and go into a 128-D flat inner-product index (``.npz``, the
JAX package's format, so either package serves it); ``manual=True`` saves
the raw (N, D) matrix instead (``.npz``, key ``embeddings``) for
brute-force cross-checks; ``images.csv`` maps row id -> path. With a
``mesh`` the trainer is built on it (the net embeds on its home device)
and the index is row-sharded over it, as the JAX package's.

    python -m image_search_engine_tpu_torch.training.siamese.create_index \
        --images-dir cards/train --ckpt-dir artifacts/siamese_ckpts [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.training.siamese.config import (
    SiameseConfig, get_latest_checkpoint)
from image_search_engine_tpu_torch.training.siamese.train import Trainer
from image_search_engine_tpu_torch.utils.imageio import (
    get_image_paths, load_images_batched, save_paths_csv)

log = logging.getLogger(__name__)


def create_index(
    cfg: SiameseConfig,
    images_dir: str | Path,
    out_index: str | Path,
    out_csv: str | Path,
    checkpoint: str | Path | None = None,
    manual: bool = False,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> FlatIndex | np.ndarray:
    """Embed a corpus with the trained net and build the index on ``device``
    (on ``mesh``, sharded, when one is given).

    manual=False -> FlatIndex("ip") over normalized rows (faiss IndexFlatIP
    parity); manual=True -> the normalized (N, D) f32 matrix saved as .npz
    (the reference's pickle "manual" index, for brute-force cross-checks).
    """
    trainer = Trainer(cfg, device=device, mesh=mesh)
    ckpt = checkpoint or get_latest_checkpoint(cfg.ckpt_dir)
    if ckpt is not None:
        trainer.load_checkpoint(ckpt)
        log.info("loaded checkpoint %s", ckpt)
    else:
        log.warning("no checkpoint found; using fresh weights")

    paths = get_image_paths(images_dir)
    embs, kept = [], []
    for batch, idx in load_images_batched(paths, cfg.batch_size, cfg.image_size):
        embs.append(trainer.embed(batch, batch_size=cfg.batch_size))
        kept.extend(idx)
    emb = np.concatenate(embs)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    save_paths_csv([paths[i] for i in kept], out_csv)

    if manual:
        np.savez_compressed(out_index, embeddings=emb)
        log.info("manual index: (%d, %d) matrix -> %s", *emb.shape, out_index)
        return emb
    index = FlatIndex("ip", device=trainer.device, mesh=mesh).add(emb)
    index.save(out_index)
    log.info("flat IP index: %d x %d-D -> %s", emb.shape[0], emb.shape[1], out_index)
    return index


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images-dir", type=Path, required=True)
    ap.add_argument("--ckpt-dir", type=Path, default=Path("artifacts/siamese_ckpts"))
    ap.add_argument("--out-index", type=Path, default=Path("artifacts/siamese.index.npz"))
    ap.add_argument("--out-csv", type=Path, default=Path("artifacts/siamese_images.csv"))
    ap.add_argument("--manual", action="store_true")
    ap.add_argument("--backbone", default="densenet121")
    ap.add_argument("--image-size", type=int, nargs=2, default=(352, 256),
                    metavar=("H", "W"))
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the card) or cpu")
    a = ap.parse_args(argv)
    cfg = SiameseConfig(ckpt_dir=a.ckpt_dir, backbone=a.backbone,
                        image_size=tuple(a.image_size), embedding_dim=a.embedding_dim)
    create_index(cfg, a.images_dir, a.out_index, a.out_csv, manual=a.manual, device=a.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
