"""Batched image preprocessing on the device.

Port of ``image_search_engine_tpu/ops/image_ops.py``: the CNN input
(resize, then ImageNet or BiT's unit normalization) and the descriptors'
colour ops (gray, HSV, the masked HSV histogram, the colour descriptor's
five regions). Images are NHWC at every public function, as in the JAX
package: float32 RGB in [0, 1] or uint8 in [0, 255], shape (B, H, W, 3) or
(H, W, 3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import device_constant
from image_search_engine_tpu_torch.ops.filters import separable

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_unit_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [0, 1]. uint8 values go
    through a table of ``np.float32(v) / 255``, the host decoder's values
    bit for bit on every device (CUDA divides by a host scalar as a product
    with its reciprocal, which rounds some quotients the other way)."""
    if img.dtype == torch.uint8:
        table = device_constant("unit_f32", img.device, lambda: torch.from_numpy(
            np.arange(256, dtype=np.float32) / np.float32(255.0)))
        return table[img.long()]
    return img.to(torch.float32)


def resize(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) or (H, W, C), antialiased when it
    downsamples, like ``jax.image.resize(method="bilinear")``; the identity
    at the same size."""
    batched = img.dim() == 4
    x = img if batched else img[None]
    if tuple(x.shape[1:3]) != (height, width):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return x if batched else x[0]


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel, RGB in [0, 1], channels last."""
    mean = device_constant(("imagenet_mean", img.dtype), img.device,
                           lambda: torch.tensor(IMAGENET_MEAN, dtype=img.dtype))
    std = device_constant(("imagenet_std", img.dtype), img.device,
                          lambda: torch.tensor(IMAGENET_STD, dtype=img.dtype))
    return (img - mean) / std


def preprocess_for_cnn(img: torch.Tensor, size: int = 224, norm: str = "imagenet") -> torch.Tensor:
    """resize to (size, size) + normalization: ``"imagenet"`` (the
    torchvision-layout backbones, ResNet and DenseNet) or ``"unit"``,
    (x - 0.5) / 0.5 (HF ``BitImageProcessor``'s, for BiT)."""
    x = resize(img, size, size)
    if norm == "unit":
        return (x - 0.5) / 0.5
    if norm != "imagenet":
        raise ValueError(f"norm must be 'imagenet' or 'unit', got {norm!r}")
    return normalize_imagenet(x)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method="bilinear")``
    along one axis, computed in f32 as it computes them: the triangle
    kernel at the f32 sample positions, widened by the scale when it
    downsamples (antialiasing), each row normalized."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / max(inv, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, f32(0.0))
    return w.T.astype(np.float64)


def resize_gray(gray: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) float images to (..., height, width),
    ``jax.image.resize``'s weights, as two float64 products rounded to f32
    (``filters.separable``): the same bits on the card and the CPU, so the
    keypoints detected on a pyramid level and the dHash bits do not depend
    on the device. The identity at the same size."""
    h, w = gray.shape[-2:]
    if (h, w) == (height, width):
        return gray
    dev = gray.device
    mh = device_constant(("resize", h, height), dev,
                         lambda: torch.from_numpy(resize_weights(h, height)))
    mw = device_constant(("resize", w, width), dev,
                         lambda: torch.from_numpy(resize_weights(w, width)))
    return separable(gray, mh, mw)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv2's COLOR_*2GRAY weights): (..., H, W, 3) ->
    (..., H, W)."""
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] -> HSV with H in [0, 360), S, V in [0, 1] (cv2's float
    convention)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, h * 60.0, 0.0)
    h = torch.where(h < 0, h + 360.0, h)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_histogram_3d(
    hsv: torch.Tensor,
    mask: torch.Tensor,
    bins: Tuple[int, int, int] = (8, 12, 3),
    ranges: Tuple[Tuple[float, float], ...] = ((0.0, 360.0), (0.0, 1.0), (0.0, 1.0)),
) -> torch.Tensor:
    """Masked 3-D HSV histograms, flattened and normalized to sum 1.
    hsv (..., H, W, 3) against mask (..., H, W) (broadcast against each
    other) -> (..., prod(bins)). The weights are the mask's 0/1 values, so
    the counts are exact in any order of summation, and the bins the same
    on every device."""
    idx = []
    for c, (nb, (lo, hi)) in enumerate(zip(bins, ranges)):
        # a device tensor as divisor: a correctly rounded quotient on CUDA too
        t = (hsv[..., c] - lo) / torch.full((), hi - lo, device=hsv.device) * nb
        idx.append(torch.clamp(t.to(torch.int32), 0, nb - 1))
    flat = (idx[0] * bins[1] + idx[1]) * bins[2] + idx[2]
    flat, w = torch.broadcast_tensors(flat, mask.to(torch.float32))
    lead = flat.shape[:-2]
    nbins = bins[0] * bins[1] * bins[2]
    hist = torch.zeros(lead + (nbins,), dtype=torch.float32, device=hsv.device)
    hist.scatter_add_(-1, flat.reshape(lead + (-1,)).long(), w.reshape(lead + (-1,)))
    return hist / torch.clamp(hist.sum(-1, keepdim=True), min=1e-12)


def five_region_masks(h: int, w: int, device="cpu") -> torch.Tensor:
    """The colour descriptor's segmentation: four corner rectangles minus
    the centre ellipse, then the ellipse. (5, H, W) f32 (TL, TR, BR, BL,
    centre)."""
    cy, cx = h / 2.0, w / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ax, ay = 0.75 * w / 2.0, 0.75 * h / 2.0
    ellipse = ((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0
    top, left = ys < cy, xs < cx
    corners = torch.stack([top & left, top & ~left, ~top & ~left, ~top & left]) & ~ellipse
    return torch.cat([corners, ellipse[None]]).to(torch.float32)
