"""Siamese metric-learning workflow: train -> create index -> evaluate.

Twin of the repo's ``examples/siamese_workflow.py`` on the port: train the
embedding net on a folder of single-instance-class images (e.g. trading
cards), build a 128-D cosine index, and cross-check the index against
brute force. Runs on the card unless ``--device cpu`` is given.

    python -m image_search_engine_tpu_torch.examples.siamese_workflow \\
        --train-dir cards/train --valid-dir cards/valid [--device cuda|cpu]

From a RANDOM backbone the pair-based ``self_supervised_circle`` loss is
the stable choice, at the reference lr of 1e-4. Best-val gating may not
have saved the last epochs of a run stopped mid-descent: call
``Trainer.save_checkpoint`` on the final state before building an index
from "the latest checkpoint".
"""

from __future__ import annotations

import argparse
import logging
import tempfile
from pathlib import Path

from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.create_index import create_index
from image_search_engine_tpu_torch.training.siamese.eval import query_index, recall_at_k
from image_search_engine_tpu_torch.training.siamese.train import Trainer


def main(argv=None) -> dict:
    """Train, index, cross-check; returns {best_val, recall, work}."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-dir", type=Path, required=True)
    ap.add_argument("--valid-dir", type=Path, required=True)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--loss", default="circle")
    ap.add_argument("--backbone", default="densenet121")
    ap.add_argument("--image-size", type=int, nargs=2, default=(352, 256))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work-dir", type=Path, default=None,
                    help="where checkpoints and artifacts go (default: a new temp dir)")
    args = ap.parse_args(argv)

    work = args.work_dir or Path(tempfile.mkdtemp(prefix="ise_siamese_"))
    cfg = SiameseConfig(
        train_dir=args.train_dir, valid_dir=args.valid_dir,
        ckpt_dir=work / "ckpts", log_file=work / "metrics.jsonl",
        backbone=args.backbone, image_size=tuple(args.image_size),
        loss=args.loss, epochs=args.epochs, batch_size=args.batch_size,
    )

    print("training ...")
    trainer = Trainer(cfg, device=args.device)
    result = trainer.run(steps_per_epoch=args.steps_per_epoch)
    print(f"best val loss: {result['best_val']:.4f}")

    print("building index ...")
    index = create_index(cfg, args.train_dir, work / "siamese.index.npz", work / "images.csv",
                         device=args.device)
    manual = create_index(cfg, args.train_dir, work / "manual.npz", work / "images.csv",
                          manual=True, device=args.device)

    # cross-check: flat index vs brute force (the reference's oracle)
    q = manual[:8]
    _, fi = query_index(q, index, "flat", k=cfg.n_results)
    _, bi = query_index(q, manual, "bruteforce", k=cfg.n_results)
    recall = recall_at_k(fi, bi)
    print(f"flat-vs-bruteforce recall@{cfg.n_results}: {recall:.3f}")
    print(f"artifacts in {work}")
    return {"best_val": result["best_val"], "recall": recall, "work": work}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
