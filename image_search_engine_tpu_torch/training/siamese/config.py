"""Siamese training configuration + checkpoint-name utilities.

A copy of ``image_search_engine_tpu/training/siamese/config.py`` (the port
imports nothing of that package): image size 352 x 256 (the reference's
357 x 256 to a multiple of 8), 128-D embeddings, SGD momentum 0.937, lr
1e-4, 100 epochs, N_RESULTS = 9, and the
``epoch_{epoch:02d}-loss_{val_loss:.4f}`` checkpoint naming with its
latest-epoch resume scan. No import-time filesystem side effects.

One deliberate difference: a checkpoint is a ``torch.save`` file named
``epoch_{e:02d}-loss_{v:.4f}.pt``, and ``CKPT_RE`` and the latest-epoch
and best-val scans read that suffix. The JAX package writes flax msgpack
(``.msgpack``), which the port cannot read without flax, so the two
packages' training checkpoints do not cross (the embedder's ``save`` /
``load`` made the same choice); the index artifacts of ``create_index``
do."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional, Tuple

CKPT_RE = re.compile(r"epoch_(\d+)-loss_(\d+\.\d+)\.pt$")


def ckpt_filename(epoch: int, val_loss: float) -> str:
    return f"epoch_{epoch:02d}-loss_{val_loss:.4f}.pt"


def extract_epoch_and_loss(name: str) -> Optional[Tuple[int, float]]:
    """Parse (epoch, val_loss) out of a checkpoint filename (reference
    extract_epoch_and_loss, siamese/config.py:10-24)."""
    m = CKPT_RE.search(str(name))
    if not m:
        return None
    return int(m.group(1)), float(m.group(2))


def get_latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    """Highest-epoch checkpoint in a directory (reference
    get_latest_epoch_filename, siamese/config.py:26-38)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best: Optional[Tuple[int, Path]] = None
    for p in ckpt_dir.iterdir():
        parsed = extract_epoch_and_loss(p.name)
        if parsed and (best is None or parsed[0] > best[0]):
            best = (parsed[0], p)
    return best[1] if best else None


def get_best_val_loss(ckpt_dir: str | Path) -> float:
    """Lowest recorded val loss (the ModelCheckpoint
    ``initial_value_threshold`` resume semantics, siamese_tf/train.py:113-120)."""
    ckpt_dir = Path(ckpt_dir)
    losses = [
        extract_epoch_and_loss(p.name)[1]
        for p in (ckpt_dir.iterdir() if ckpt_dir.exists() else [])
        if extract_epoch_and_loss(p.name)
    ]
    return min(losses) if losses else float("inf")


@dataclasses.dataclass
class SiameseConfig:
    train_dir: Path = Path("data/siamese/train")
    valid_dir: Path = Path("data/siamese/valid")
    ckpt_dir: Path = Path("artifacts/siamese_ckpts")
    log_file: Path = Path("artifacts/siamese_metrics.jsonl")

    backbone: str = "densenet121"
    torch_weights: Optional[Path] = None  # torchvision densenet .pth to
    # load as the backbone init (the reference trains from pretrained
    # torchvision densenet121)
    image_size: Tuple[int, int] = (352, 256)  # the reference's (357, 256)
    embedding_dim: int = 128
    freeze_backbone: bool = True
    loss: str = "circle"  # "triplet" | "circle" | "self_supervised_circle"
    triplet_margin: float = 0.5
    circle_margin: float = 0.25
    circle_scale: float = 256.0

    batch_size: int = 32  # the reference trains at 4
    epochs: int = 100
    lr: float = 1e-4
    momentum: float = 0.937
    # ReduceLROnPlateau equivalents (siamese_tf/train.py:124-130)
    lr_reduce_factor: float = 0.5
    lr_reduce_patience: int = 7

    n_results: int = 9
    seed: int = 0

    # forward/backward compute precision. Params, optimizer state, batch
    # stats, and the loss stay f32 (the head casts embeddings back to f32,
    # model.py); "bf16" runs the convolutions and products under
    # torch.autocast(bfloat16), "f32" in IEEE f32 (TF32 off on the card).
    compute_dtype: str = "bf16"  # "bf16" | "f32"

    def __post_init__(self) -> None:
        self.train_dir = Path(self.train_dir)
        self.valid_dir = Path(self.valid_dir)
        self.ckpt_dir = Path(self.ckpt_dir)
        self.log_file = Path(self.log_file)
        if self.compute_dtype not in ("bf16", "f32"):
            raise ValueError(
                f"compute_dtype must be 'bf16' or 'f32', got {self.compute_dtype!r}"
            )
