"""Colour-moment hash: 42 moment invariants per image.

Port of ``image_search_engine_tpu/ops/color_moment_hash.py`` (the
reference's ``cv2.img_hash.colorMomentHash``): the first 7 Hu invariants of
each channel in YCbCr and in HSV (hue scaled to [0, 1]) -> 3 * 2 * 7 = 42
features per image, matched by plain L2.
"""

from __future__ import annotations

import torch

from image_search_engine_tpu_torch.ops.image_ops import rgb_to_hsv


def _rgb_to_ycbcr(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return torch.stack([y, cb, cr], dim=-1)


def _hu_moments(ch: torch.Tensor) -> torch.Tensor:
    """The first 7 Hu invariants of a (B, H, W) channel batch -> (B, 7)."""
    _, h, w = ch.shape
    ys = torch.arange(h, dtype=torch.float32, device=ch.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=ch.device)[None, None, :]
    m00 = torch.sum(ch, dim=(1, 2)) + 1e-12
    m10 = torch.sum(ch * ys, dim=(1, 2))
    m01 = torch.sum(ch * xs, dim=(1, 2))
    dy = ys - (m10 / m00)[:, None, None]
    dx = xs - (m01 / m00)[:, None, None]

    def eta(p, q):
        return torch.sum(ch * dy**p * dx**q, dim=(1, 2)) / m00 ** (1 + (p + q) / 2.0)

    n20, n02, n11 = eta(2, 0), eta(0, 2), eta(1, 1)
    n30, n03, n21, n12 = eta(3, 0), eta(0, 3), eta(2, 1), eta(1, 2)
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11**2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) + (
        3 * n21 - n03) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (n30 + n12) * (
        n21 + n03)
    h7 = (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) - (
        n30 - 3 * n12) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    return torch.stack([h1, h2, h3, h4, h5, h6, h7], dim=1)


def color_moment_hash(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB [0, 1] -> (B, 42) moment-hash features."""
    hsv = rgb_to_hsv(images)
    hsv = torch.cat([hsv[..., :1] / 360.0, hsv[..., 1:]], dim=-1)  # comparable scales
    feats = [_hu_moments(space[..., c]) for space in (_rgb_to_ycbcr(images), hsv)
             for c in range(3)]
    return torch.cat(feats, dim=1)
