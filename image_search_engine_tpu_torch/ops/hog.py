"""Histogram-of-Oriented-Gradients descriptor.

Port of ``image_search_engine_tpu/ops/hog.py`` (the reference's skimage HOG:
9 orientations, 32 x 32-pixel cells, 2 x 2-cell blocks, L2-Hys block
norm), batched over images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops.filters import gradients


def hog(img: torch.Tensor, orientations: int = 9, cell_size: int = 32, block_size: int = 2,
        eps: float = 1e-6) -> torch.Tensor:
    """HOG feature vector(s) of (H, W) or (B, H, W) gray float images, H
    and W cropped to whole cells: (F,) or (B, F), F = n_blocks_y *
    n_blocks_x * block_size^2 * orientations. A pixel whose orientation
    lies at a bin edge votes into the bin its f32 ``atan2`` falls in."""
    batched = img.dim() == 3
    if not batched:
        img = img[None]
    b, h, w = img.shape
    cy, cx = (h // cell_size) * cell_size, (w // cell_size) * cell_size
    img = img[:, :cy, :cx]
    n_cy, n_cx = cy // cell_size, cx // cell_size

    gy, gx = gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)  # unsigned, [0, 180)

    bin_idx = torch.clamp((ang / (180.0 / orientations)).to(torch.int32), 0, orientations - 1)
    votes = F.one_hot(bin_idx.long(), orientations).to(torch.float32) * mag[..., None]
    cells = votes.reshape(b, n_cy, cell_size, n_cx, cell_size, orientations).sum(dim=(2, 4))

    n_by, n_bx = n_cy - block_size + 1, n_cx - block_size + 1
    blocks = torch.cat([cells[:, dy:dy + n_by, dx:dx + n_bx, :]
                        for dy in range(block_size) for dx in range(block_size)], dim=-1)

    def l2n(v):  # L2-Hys: normalize, clip at 0.2, normalize again
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps**2)

    out = l2n(torch.clamp(l2n(blocks), max=0.2)).reshape(b, -1)
    return out if batched else out[0]
