"""Pair batches for siamese training.

Port of ``image_search_engine_tpu/training/siamese/dataset.py``: infinite
(anchor, negative) image batches, where the *positive is an augmented copy
of the anchor* (made on the device inside the train step,
training/siamese/augmentations.py) and the negative is any other random
file — the single-instance-per-class assumption of the reference's card
dataset. The numpy ``default_rng(seed)`` calls are the JAX package's, in
its order, so both packages draw the same index batches for a seed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np

from image_search_engine_tpu_torch.utils.imageio import get_image_paths, load_image_u8


class PairsGenerator:
    """Infinite (anchor_batch, negative_batch) image batches."""

    def __init__(
        self,
        paths: Sequence[str | Path],
        batch_size: int,
        image_size: Tuple[int, int],
        seed: int = 0,
    ):
        if len(paths) < 2:
            raise ValueError("need at least 2 images for anchor/negative pairs")
        self.paths = [str(p) for p in paths]
        self.batch_size = batch_size
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_dir(cls, folder, batch_size, image_size, seed=0) -> "PairsGenerator":
        return cls(get_image_paths(folder), batch_size, image_size, seed)

    def steps_per_epoch(self) -> int:
        # the reference derives steps from file counts
        return max(1, len(self.paths) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        import concurrent.futures as cf

        n = len(self.paths)
        with cf.ThreadPoolExecutor(8) as pool:
            while True:
                anchor_idx = self.rng.integers(0, n, self.batch_size)
                # negative: any *other* random file
                offset = self.rng.integers(1, n, self.batch_size)
                negative_idx = (anchor_idx + offset) % n
                idx = np.concatenate([anchor_idx, negative_idx])
                # decode the whole pair batch in parallel threads (the PIL
                # decode releases the GIL); keeps the device fed. Batches
                # stay uint8 on the host — 4x lighter uploads; the train
                # step casts to [0,1] f32 on the device (ops/image_ops.
                # to_unit_f32, same convention as the corpus path)
                imgs = list(pool.map(
                    lambda i: load_image_u8(self.paths[i], self.image_size), idx
                ))
                both = np.stack(imgs)
                yield both[: self.batch_size], both[self.batch_size :]
