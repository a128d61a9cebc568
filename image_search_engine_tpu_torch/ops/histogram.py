"""Codeword histograms for BoVW.

Port of ``image_search_engine_tpu/ops/histogram.py``: descriptor codes
scattered into per-image codeword histograms, in one scatter-add on the
device. Every weight is 0 or 1, so the counts are exact in any order of
summation (the CUDA scatter's atomics included).
"""

from __future__ import annotations

import torch


def codes_to_histograms(codes: torch.Tensor, image_ids: torch.Tensor, num_images: int,
                        num_clusters: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(T,) codes of descriptors owned by (T,) image rows -> (num_images,
    num_clusters) f32 counts; ``valid`` (T,) bool drops padded slots."""
    flat = image_ids.long() * num_clusters + codes.long()
    weights = torch.ones(flat.shape, dtype=torch.float32, device=codes.device)
    if valid is not None:
        weights = torch.where(valid, weights, 0.0)
        flat = torch.where(valid, flat, 0)
    hist = torch.zeros(num_images * num_clusters, dtype=torch.float32, device=codes.device)
    hist.index_add_(0, flat, weights)
    return hist.view(num_images, num_clusters)


def batched_histograms(codes: torch.Tensor, valid: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """(B, M) codes with (B, M) bool ``valid`` (every image has M slots,
    the padded ones masked) -> (B, num_clusters) f32 counts."""
    hist = torch.zeros((codes.shape[0], num_clusters), dtype=torch.float32,
                       device=codes.device)
    return hist.scatter_add_(1, codes.long(), valid.to(torch.float32))
