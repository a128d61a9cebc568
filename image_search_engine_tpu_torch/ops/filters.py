"""Shared image filters: separable Gaussian blur, image gradients, Sobel.

Port of ``image_search_engine_tpu/ops/filters.py``, the building blocks of
the descriptors (HOG, DAISY, the corner descriptors). The JAX package runs
each filter as an f32 convolution over a reflect-padded copy. Here each
filter along one axis is a banded (n, n) matrix whose rows hold the taps,
with the reflect padding folded in (a tap that falls outside the image adds
its weight to the pixel numpy's ``mode="reflect"`` reads, reflecting again
where the pad exceeds the size), and the image is multiplied by it in
float64, then rounded to f32. So:

  * no TF32 pass whatever the global flags say (``torch.backends.cudnn.
    allow_tf32`` is on by default and would round a convolution's inputs
    to 10 mantissa bits);
  * each output is the f32 rounding of a float64 sum, the same bits on the
    card and the CPU but where a sum lies within a float64 error of an f32
    rounding boundary, so the Harris responses, and with them the
    keypoints, do not depend on the device;
  * the result differs from the JAX package's f32 sums by their own
    rounding, a few f32 ulps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from image_search_engine_tpu_torch.ops import device_constant


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> torch.Tensor:
    """The normalized f32 taps of a Gaussian, ``2 * radius + 1`` of them
    (radius ceil(3 sigma) by default)."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def reflect_index(n: int, r: int) -> np.ndarray:
    """The source pixel of each of the n + 2r positions of an axis padded by
    r on both sides with numpy's (and ``jnp.pad``'s) ``mode="reflect"``:
    the edge pixel is not repeated, and a pad longer than the axis reflects
    again. ``torch.nn.functional.pad`` refuses such pads."""
    return np.pad(np.arange(n), r, mode="reflect")


def band_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """(n, n) float64 matrix of a "valid" correlation with ``taps`` (odd
    length 2r + 1) over the axis reflect-padded by r: row i holds tap t at
    the source of padded position i + t."""
    taps = np.asarray(taps, np.float64)
    r = (taps.shape[0] - 1) // 2
    src = reflect_index(n, r)
    m = np.zeros((n, n), np.float64)
    rows = np.repeat(np.arange(n), taps.shape[0])
    cols = src[np.arange(n)[:, None] + np.arange(taps.shape[0])[None, :]].reshape(-1)
    np.add.at(m, (rows, cols), np.tile(taps, n))
    return m


def separable(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor,
              round_between: bool = True) -> torch.Tensor:
    """``mh @ x @ mw.T`` over the last two axes of f32 ``x`` (..., H, W),
    with float64 (out, in) matrices, in float64; the result rounded to f32,
    and the intermediate too with ``round_between`` (as two f32 passes)."""
    lead = x.shape[:-2]
    y = torch.matmul(mh, x.reshape((-1,) + x.shape[-2:]).double())
    if round_between:
        y = y.float().double()
    y = torch.matmul(y, mw.T).float()
    return y.reshape(lead + y.shape[-2:])


def _band(name, n: int, taps_fn, device) -> torch.Tensor:
    return device_constant((name, n), device,
                           lambda: torch.from_numpy(band_matrix(n, taps_fn())))


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur over (..., H, W) with reflect padding, the
    rows first, then the columns, each pass rounded to f32."""
    h, w = img.shape[-2:]
    taps = lambda: gaussian_kernel_1d(sigma, radius).numpy()  # noqa: E731
    name = ("gaussian", float(sigma), radius)
    return separable(img, _band(name, h, taps, img.device), _band(name, w, taps, img.device))


def gradients(img: torch.Tensor):
    """Centred-difference gradients (np.gradient semantics: one-sided at the
    borders) over (..., H, W). Returns (gy, gx)."""
    gy = torch.cat([img[..., 1:2, :] - img[..., 0:1, :],
                    (img[..., 2:, :] - img[..., :-2, :]) * 0.5,
                    img[..., -1:, :] - img[..., -2:-1, :]], dim=-2)
    gx = torch.cat([img[..., :, 1:2] - img[..., :, 0:1],
                    (img[..., :, 2:] - img[..., :, :-2]) * 0.5,
                    img[..., :, -1:] - img[..., :, -2:-1]], dim=-1)
    return gy, gx


_SMOOTH = lambda: np.array([1.0, 2.0, 1.0])  # noqa: E731
_DIFF = lambda: np.array([-1.0, 0.0, 1.0])  # noqa: E731


def sobel(img: torch.Tensor):
    """3x3 Sobel gradients over (..., H, W) with reflect padding: (gy, gx).
    Each kernel is the outer product of [1, 2, 1] and [-1, 0, 1], so the
    float64 products are exact and each output is the f32 rounding of the
    exact sum."""
    h, w = img.shape[-2:]
    dev = img.device
    sh, dh = _band("sobel_smooth", h, _SMOOTH, dev), _band("sobel_diff", h, _DIFF, dev)
    sw, dw = _band("sobel_smooth", w, _SMOOTH, dev), _band("sobel_diff", w, _DIFF, dev)
    return (separable(img, dh, sw, round_between=False),
            separable(img, sh, dw, round_between=False))
