"""DAISY dense descriptors (Tola et al., TPAMI 2010).

Port of ``image_search_engine_tpu/ops/daisy.py`` (the reference's skimage
DAISY: step 32, radius 32, 2 rings, 8 histograms, 8 orientations -> 136-D
descriptors on a dense grid): orientation maps by elementwise trig, the ring
pooling as cumulative Gaussian blurs (ops/filters.py, float64 products, so
no TF32 pass), and the grid sampling as static strided slices: no index
tensor, nothing to upload inside a captured dispatch.
"""

from __future__ import annotations

import math

import torch

from image_search_engine_tpu_torch.ops.filters import gaussian_blur


def _grid_slice(centres: list, offset: int, size: int, step: int) -> slice:
    """The positions ``centres + offset`` along an axis of ``size`` as a
    slice, with the JAX package's index semantics: a negative index counts
    from the end, then indices clamp to the axis. Only the one-centre
    fallback (an image smaller than the ring) reaches either rule; a grid
    of several centres stays inside the axis."""
    idx = [min(max(i + size if i < 0 else i, 0), size - 1) for i in
           (c + offset for c in centres)]
    return slice(idx[0], idx[-1] + 1, step)


def daisy(img: torch.Tensor, step: int = 32, radius: int = 32, rings: int = 2,
          histograms: int = 8, orientations: int = 8,
          normalization: str = "l1") -> torch.Tensor:
    """DAISY descriptors on a dense grid of (H, W) or (B, H, W) gray float
    images: (B, P, D) (or (P, D)), P grid points, D = (rings * histograms
    + 1) * orientations. ``normalization``: "l1", "l2", "daisy" (each
    histogram l2) or "off"."""
    batched = img.dim() == 3
    if not batched:
        img = img[None]
    b, h, w = img.shape

    # oriented gradient maps G_o = max(0, cos(grad_ori - theta_o)) * |grad|
    zrow = torch.zeros((b, 1, w), dtype=img.dtype, device=img.device)
    zcol = torch.zeros((b, h, 1), dtype=img.dtype, device=img.device)
    dy = torch.cat([img[:, 1:, :] - img[:, :-1, :], zrow], dim=1)
    dx = torch.cat([img[:, :, 1:] - img[:, :, :-1], zcol], dim=2)
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    thetas = torch.arange(orientations, dtype=torch.float32, device=img.device) * (
        2.0 * math.pi / orientations)
    maps = torch.clamp(torch.cos(ori[:, None] - thetas[None, :, None, None]),
                       min=0.0) * mag[:, None]  # (B, O, H, W)

    # cumulative Gaussian pooling: the centre's sigma, then one per ring
    pooled, cur, prev_sigma = [], maps, 0.0
    for i in range(rings + 1):
        s = radius / (2.0 * rings) * (i + 1)
        cur = gaussian_blur(cur, math.sqrt(max(s**2 - prev_sigma**2, 1e-6)))
        pooled.append(cur)
        prev_sigma = s

    ys = list(range(radius, h - radius, step)) or [h // 2]
    xs = list(range(radius, w - radius, step)) or [w // 2]

    def sample(m, oy: int, ox: int):  # (B, O, H, W) -> (B, O, len(ys), len(xs))
        return m[:, :, _grid_slice(ys, oy, h, step), _grid_slice(xs, ox, w, step)]

    parts = [sample(pooled[0], 0, 0)]
    for r in range(rings):
        rad = (r + 1) * radius / rings
        for j in range(histograms):
            ang = 2.0 * math.pi * j / histograms
            parts.append(sample(pooled[r + 1], int(round(rad * math.sin(ang))),
                                int(round(rad * math.cos(ang)))))
    n_hist = 1 + rings * histograms
    desc = torch.stack(parts, dim=1).permute(0, 3, 4, 1, 2)  # (B, P_y, P_x, n_hist, O)
    desc = desc.reshape(b, len(ys) * len(xs), n_hist, orientations)

    if normalization == "daisy":
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-10)
    desc = desc.reshape(b, -1, n_hist * orientations)
    if normalization == "l1":
        desc = desc / (torch.sum(torch.abs(desc), dim=-1, keepdim=True) + 1e-10)
    elif normalization == "l2":
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-10)
    elif normalization not in ("daisy", "off"):
        raise ValueError(f"unknown normalization {normalization!r}")
    return desc if batched else desc[0]
