"""Run the siamese "training improves retrieval" recipe at several trainer
seeds, through either package, and print each run's recall@1 and gap
before and after training.

The recipe is the JAX package's (tests/test_siamese.py,
``test_training_improves_retrieval``): densenet-tiny at 64 px, 32 synthetic
cards (``make_synthetic_card_corpus(32, 64, q_per=4)``), self-supervised
circle loss, lr 1e-4, batch 16, 12 epochs of 8 steps. The seed is
``SiameseConfig.seed``: it draws the initial weights and the training
batches' order and augmentation, while the card corpus stays the same.

    python siamese_recipe_seeds.py --package jax --seeds 0-5 --dtypes bf16,f32
    python siamese_recipe_seeds.py --package torch --device cuda --seeds 0-5

The JAX package runs on the CPU only (``JAX_PLATFORMS=cpu``); the port runs
on ``--device`` (the card unless the CPU is asked for). Each run prints one
JSON line; the last line holds every run and the median gains per dtype.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def parse_seeds(text: str) -> list:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def recipe_run(package: str, root: Path, seed: int, dtype: str, device: str) -> dict:
    from PIL import Image

    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from image_search_engine_tpu.training.siamese.config import SiameseConfig
        from image_search_engine_tpu.training.siamese.eval import (
            card_retrieval_metrics, make_synthetic_card_corpus)
        from image_search_engine_tpu.training.siamese.train import Trainer

        kw = {}
    else:
        from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
        from image_search_engine_tpu_torch.training.siamese.eval import (
            card_retrieval_metrics, make_synthetic_card_corpus)
        from image_search_engine_tpu_torch.training.siamese.train import Trainer

        kw = {"device": device}
    cards, queries, qlabel = make_synthetic_card_corpus(32, 64, q_per=4)
    train = root / "train"
    if not train.exists():
        train.mkdir(parents=True)
        for i in range(cards.shape[0]):
            Image.fromarray((cards[i] * 255).astype(np.uint8)).save(train / f"card_{i:03d}.png")
    run_dir = Path(tempfile.mkdtemp(dir=root))
    cfg = SiameseConfig(train_dir=train, valid_dir=train, ckpt_dir=run_dir / "ckpts",
                        log_file=run_dir / "m.jsonl", backbone="densenet-tiny",
                        image_size=(64, 64), embedding_dim=32, freeze_backbone=False,
                        loss="self_supervised_circle", lr=1e-4, batch_size=16, seed=seed,
                        compute_dtype=dtype)
    tr = Trainer(cfg, **kw)
    embed = lambda x: tr.embed(x, batch_size=32)  # noqa: E731
    before = card_retrieval_metrics(embed, cards, queries, qlabel, **kw)
    t0 = time.perf_counter()
    tr.run(epochs=12, steps_per_epoch=8, val_steps=1)
    train_s = time.perf_counter() - t0
    after = card_retrieval_metrics(embed, cards, queries, qlabel, **kw)
    return {"package": package, "device": "cpu" if package == "jax" else device, "dtype": dtype,
            "seed": seed, "before": before, "after": after, "train_s": train_s,
            "recall_at_1_gain": after["recall_at_1"] - before["recall_at_1"],
            "gap_gain": after["gap"] - before["gap"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device (cuda or cpu)")
    ap.add_argument("--seeds", default="0-5", help="'0-5' or '0,3,4'")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: torch's own)")
    args = ap.parse_args(argv)
    if args.threads:
        import torch

        torch.set_num_threads(args.threads)
    runs = []
    with tempfile.TemporaryDirectory(prefix="recipe_") as tmp:
        for dtype in args.dtypes.split(","):
            for seed in parse_seeds(args.seeds):
                runs.append(recipe_run(args.package, Path(tmp), seed, dtype, args.device))
                print(json.dumps(runs[-1]), flush=True)
    median = {d: {k: float(np.median([r[k] for r in runs if r["dtype"] == d]))
                  for k in ("recall_at_1_gain", "gap_gain")} for d in args.dtypes.split(",")}
    print(json.dumps({"runs": runs, "median": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
