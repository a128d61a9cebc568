"""End-to-end quickstart: index a folder, query it, print results.

Twin of the repo's ``examples/quickstart.py`` on the port. Generates a
small synthetic corpus if you don't pass one. Runs on the card unless
``--device cpu`` is given.

    python -m image_search_engine_tpu_torch.examples.quickstart \\
        [--data-dir photos/] [--method dnn|bovw|dhash] [--model resnet50] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu_torch.engine import QueryEngine
from image_search_engine_tpu_torch.indexer import main as build_index
from image_search_engine_tpu_torch.utils.imageio import load_image


def synthetic_corpus(root: Path, groups=4, per_group=5, size=96) -> Path:
    """``groups`` x ``per_group`` PNGs: a seeded smooth colour field per
    group plus a little noise per image."""
    rng = np.random.default_rng(0)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    for g in range(groups):
        low = rng.random((8, 8, 3)) * 0.7 + 0.15
        base = np.asarray(
            Image.fromarray((low * 255).astype(np.uint8)).resize((size, size)), np.float32
        ) / 255.0
        for i in range(per_group):
            img = np.clip(base + 0.03 * rng.standard_normal(base.shape), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / f"g{g}_{i}.png")
    return img_dir


def main(argv=None):
    """Index, then query with the corpus's first image; returns the
    (distance, thumbnail, path) results it prints."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", type=Path, default=None)
    ap.add_argument("--method", default="dnn", choices=["dnn", "bovw", "dhash"])
    ap.add_argument("--model", default="resnet-tiny", help="resnet50 for real corpora")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work-dir", type=Path, default=None,
                    help="where the corpus and artifacts go (default: a new temp dir)")
    args = ap.parse_args(argv)

    work = args.work_dir or Path(tempfile.mkdtemp(prefix="ise_quickstart_"))
    data_dir = args.data_dir or synthetic_corpus(work)
    cfg = Config(
        data_dir=data_dir,
        artifacts_dir=work / "artifacts",
        method=Method(args.method),
        dnn_model=DnnModel(args.model),
        index_type=IndexType.L2,
        resize_size=96,
        embed_batch_size=8,
        num_images_to_return=5,
    )

    print(f"indexing {data_dir} ...")
    build_index(cfg, device=args.device)

    engine = QueryEngine(cfg, device=args.device)
    try:
        query_path = engine.paths[0]
        print(f"querying with {query_path}:")
        results = engine.query(load_image(query_path))
        for dist, _thumb, path in results:
            print(f"  {dist:10.4f}  {path}")
    finally:
        engine.close()
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
