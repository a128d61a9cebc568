"""Difference-hash (dHash) perceptual hashing.

Port of ``image_search_engine_tpu/ops/dhash.py``: each image resized to 8 x
9 gray pixels, bit = px[x + 1] > px[x] (64 bits), hashes packed into
uint64 on the host, and the query-time match a Hamming scan over the
stored bit matrix with the k nearest kept in (distance, index) order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.image_ops import resize_gray, rgb_to_gray, to_unit_f32

HASH_SIZE = 8  # 8x8 differences = 64 bits


def dhash_bits(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float gray images -> (B, 64) bool, the column-gradient
    bits row-major of the (8, 9) resize."""
    small = resize_gray(gray, HASH_SIZE, HASH_SIZE + 1)
    bits = small[:, :, 1:] > small[:, :, :-1]
    return bits.reshape(bits.shape[0], HASH_SIZE * HASH_SIZE)


def bits_to_int(bits: np.ndarray) -> np.ndarray:
    """(B, 64) bool -> (B,) uint64 hashes, the first bit the most
    significant."""
    bits = np.asarray(bits, np.uint64)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[::-1]
    return (bits * weights).sum(axis=1, dtype=np.uint64)


def int_to_bits(h: np.ndarray) -> np.ndarray:
    """(B,) uint64 hashes -> (B, 64) bool (the inverse of bits_to_int)."""
    h = np.asarray(h, np.uint64).reshape(-1)
    shifts = np.arange(64, dtype=np.uint64)[::-1]
    return ((h[:, None] >> shifts) & np.uint64(1)).astype(bool)


def dhash_images(images: torch.Tensor) -> np.ndarray:
    """(B, H, W, 3) RGB images (uint8, or float in [0, 1]) -> (B,) uint64."""
    return bits_to_int(dhash_bits(rgb_to_gray(to_unit_f32(images))).cpu().numpy())


def hamming_scan(query_bits: torch.Tensor, db_bits: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 Hamming distances between (Q, 64) and (N, 64) bit rows
    (bool or 0/1 float): |q| + |d| - 2 q.d. The product counts at most 64
    ones, which every f32 route (TF32 included) sums exactly."""
    q = query_bits.to(torch.float32)
    d = db_bits.to(torch.float32)
    cross = q @ d.T
    return (q.sum(1, keepdim=True) + d.sum(1)[None, :] - 2.0 * cross).to(torch.int32)


def hamming_topk(query_bits: torch.Tensor, db_bits: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest hashes: (distances int32, indices int32), ascending,
    equal distances in index order (as ``lax.top_k``: a stable sort, since
    integer distances tie as a rule)."""
    d, i = stable_smallest(hamming_scan(query_bits, db_bits), k)
    return d, i.to(torch.int32)
