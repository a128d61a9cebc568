"""Keypoint detection and local descriptors as batched, fixed-shape ops.

Port of ``image_search_engine_tpu/ops/corners.py`` (the reference's OpenCV
ORB/SIFT/BRISK ``detectAndCompute``). Every image yields exactly
``max_keypoints`` slots (the top Harris corners, the rest masked by
``valid``), so a batch has one static shape and the describe chain runs
inside a captured dispatch:

  * detection: Harris response (Sobel + Gaussian structure tensor, the
    filters' float64 products, so the same responses on the card and the
    CPU), 3x3 non-max suppression, and the top K by a stable descending
    sort (equal responses in index order, as ``lax.top_k``);
  * orientation: ORB's intensity centroid over a circular patch;
  * patches gathered at the keypoints (zeros outside the image, as the JAX
    package's one-hot products give), and the rotated test patterns
    sampled bilinearly with the orientation quantized to N_ORIENT bins.
    The JAX package multiplies each bf16 patch by precomputed (O, P*P, T)
    bf16 sampling matrices and sums in f32; each column of those matrices
    holds four weights, so here the four bf16 patch values are gathered,
    multiplied by their bf16 weights in f32 (exact) and summed in f32 in
    the matrix's row order: no matmul, no TF32, no 32 MiB constant;
  * ORB-style: 256 oriented-BRIEF tests; BRISK-style: 512 short pairs of a
    ring pattern; SIFT-style: 4x4 cells x 8 orientation bins of Gaussian-
    weighted gradient votes over an oriented 18 x 18 sample grid.

A binary test I(p1) < I(p2) flips where its two samples nearly tie, and an
orientation or gradient bin where ``atan2`` lies at a bin edge: these are
where the card, the CPU and the JAX package may part.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import device_constant
from image_search_engine_tpu_torch.ops.filters import gaussian_blur, sobel
from image_search_engine_tpu_torch.ops.image_ops import resize_gray

PATCH = 32  # extracted patch side; descriptors sample inside +-13 px
N_ORIENT = 32  # orientation bins of the pattern sampling (11.25 degrees)


class Keypoints(NamedTuple):
    ys: torch.Tensor  # (B, K) int64 row coords
    xs: torch.Tensor  # (B, K) int64 col coords
    score: torch.Tensor  # (B, K) f32 Harris response
    valid: torch.Tensor  # (B, K) bool
    theta: torch.Tensor  # (B, K) f32 orientation (radians)


def harris_response(gray: torch.Tensor, k_harris: float = 0.05) -> torch.Tensor:
    """Harris corner response over (B, H, W)."""
    gy, gx = sobel(gray)
    ixx = gaussian_blur(gx * gx, 1.5)
    iyy = gaussian_blur(gy * gy, 1.5)
    ixy = gaussian_blur(gx * gy, 1.5)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k_harris * tr * tr


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression mask (the window padded with -inf)."""
    return resp >= F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]


def detect(gray: torch.Tensor, max_keypoints: int = 256,
           border: int = PATCH // 2 + 1) -> Keypoints:
    """Top-K Harris corners of (B, H, W) float gray images, with their
    orientation; fixed-size output, ``valid`` = a positive response."""
    b, h, w = gray.shape
    smooth = gaussian_blur(gray, 1.0)
    resp = harris_response(smooth)
    ys_i = torch.arange(h, device=gray.device)[:, None]
    xs_i = torch.arange(w, device=gray.device)[None, :]
    inside = (ys_i >= border) & (ys_i < h - border) & (xs_i >= border) & (xs_i < w - border)
    masked = torch.where(_nms3(resp) & inside, resp, -math.inf)
    vals, flat = torch.sort(masked.reshape(b, -1), dim=1, descending=True, stable=True)
    vals, flat = vals[:, :max_keypoints], flat[:, :max_keypoints]
    ys, xs = flat // w, flat % w
    valid = torch.isfinite(vals) & (vals > 0)
    return Keypoints(ys=ys, xs=xs, score=vals, valid=valid, theta=_orientations(smooth, ys, xs))


def _extract_patches(gray: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(B, H, W), (B, K) -> (B, K, PATCH, PATCH) patches centred at the
    keypoints, zero where a patch leaves the image (only a masked slot's
    can: detect's border keeps valid keypoints inside)."""
    b, h, w = gray.shape
    offs = torch.arange(PATCH, device=gray.device) - PATCH // 2
    rows = ys[..., None] + offs  # (B, K, P)
    cols = xs[..., None] + offs
    bidx = torch.arange(b, device=gray.device)[:, None, None, None]
    vals = gray[bidx, rows.clamp(0, h - 1)[..., :, None], cols.clamp(0, w - 1)[..., None, :]]
    inside = (((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :])
    return torch.where(inside, vals, 0.0)


def _orientations(gray: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """ORB intensity-centroid orientation: atan2(m01, m10) of a circular
    patch around each keypoint. The moments are summed in float64 and
    rounded to f32 (the same on every device)."""
    patches = _extract_patches(gray, ys, xs)  # (B, K, P, P)
    r = PATCH // 2
    c = torch.arange(PATCH, dtype=torch.float32, device=gray.device) - (r - 0.5)
    circ = (c[:, None] ** 2 + c[None, :] ** 2) <= (r - 1) ** 2
    wpatch = (patches * circ).double()
    m01 = torch.sum(wpatch * c.double()[:, None], dim=(-2, -1)).float()
    m10 = torch.sum(wpatch * c.double()[None, :], dim=(-2, -1)).float()
    return torch.atan2(m01, m10)


def _oriented_sample_taps(pts: np.ndarray, n_orient: int = N_ORIENT):
    """The sampling matrices of the JAX package's ``_oriented_sample_matrix``
    as (O, T, 4) gather tables: the flat patch index and the weight of each
    bilinear corner of pattern point t rotated by 2 pi o / O (y' = y cos +
    x sin, x' = -y sin + x cos, plus the patch centre), corners in the
    matrix's row order; the weights rounded as the JAX package's (f32, then
    bf16)."""
    c = PATCH // 2 - 0.5
    t_count = pts.shape[0]
    idx = np.zeros((n_orient, t_count, 4), np.int64)
    wts = np.zeros((n_orient, t_count, 4), np.float64)
    for o in range(n_orient):
        th = 2.0 * math.pi * o / n_orient
        cos_t, sin_t = math.cos(th), math.sin(th)
        ry = pts[:, 0] * cos_t + pts[:, 1] * sin_t + c
        rx = -pts[:, 0] * sin_t + pts[:, 1] * cos_t + c
        y0 = np.clip(np.floor(ry).astype(np.int64), 0, PATCH - 2)
        x0 = np.clip(np.floor(rx).astype(np.int64), 0, PATCH - 2)
        wy = np.clip(ry - y0, 0.0, 1.0)
        wx = np.clip(rx - x0, 0.0, 1.0)
        for j, (dy, dx, wt) in enumerate(((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx))):
            idx[o, :, j] = (y0 + dy) * PATCH + (x0 + dx)
            wts[o, :, j] = wt
    wts = torch.from_numpy(wts.astype(np.float32)).to(torch.bfloat16).to(torch.float32)
    return torch.from_numpy(idx), wts


def _oriented_patch_values(patches: torch.Tensor, theta: torch.Tensor, pts_name: str,
                           pts_fn) -> torch.Tensor:
    """Each keypoint's pattern points sampled from its bf16-rounded patch,
    rotated by its orientation bin: (B, K, T) f32."""
    dev = patches.device
    idx = device_constant(("taps_idx", pts_name), dev, lambda: _oriented_sample_taps(pts_fn())[0])
    wts = device_constant(("taps_w", pts_name), dev, lambda: _oriented_sample_taps(pts_fn())[1])
    b, k = patches.shape[:2]
    t = idx.shape[1]
    flat = patches.reshape(b, k, -1).to(torch.bfloat16).to(torch.float32)
    o = torch.remainder(torch.round(theta * (N_ORIENT / (2.0 * math.pi))), N_ORIENT).long()
    picked = flat.gather(2, idx[o].reshape(b, k, t * 4)).reshape(b, k, t, 4) * wts[o]
    return ((picked[..., 0] + picked[..., 1]) + picked[..., 2]) + picked[..., 3]


def _brief_points(n_bits: int, radius: float, seed: int = 7) -> np.ndarray:
    """Fixed BRIEF pattern as (2 * n_bits, 2) points [y, x] (bit i compares
    point 2i with 2i + 1), Gaussian around the centre (sigma radius / 2),
    clipped to the square of the radius."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, radius / 2.0, size=(n_bits, 4)).astype(np.float32)
    return np.clip(pts, -radius, radius).reshape(n_bits * 2, 2)


def _brisk_points_pairs(radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed concentric-ring pattern: (37 points [y, x], the 512 shortest
    pairs (512, 2) of indices into them)."""
    pts = []
    for r, n in zip([0.0, radius * 0.35, radius * 0.6, radius * 0.85], [1, 8, 12, 16]):
        for j in range(n):
            a = 2 * math.pi * j / n
            pts.append((r * math.sin(a), r * math.cos(a)))
    pts = np.asarray(pts, np.float32)
    pairs, dists = [], []
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            pairs.append((i, j))
            dists.append(np.linalg.norm(pts[i] - pts[j]))
    order = np.argsort(np.asarray(dists), kind="stable")[:512]
    return pts, np.asarray(pairs, np.int32)[order]


def _binary_descriptor(patches: torch.Tensor, theta: torch.Tensor, pts_name: str, pts_fn,
                       pairs_fn) -> torch.Tensor:
    """Oriented binary tests, bit = I(p1) < I(p2) over the sampled pattern
    points: (B, K, n_bits) float 0/1."""
    v = _oriented_patch_values(patches, theta, pts_name, pts_fn)
    pairs = device_constant(("pairs", pts_name), patches.device,
                            lambda: torch.from_numpy(np.asarray(pairs_fn(), np.int64)))
    return (v[..., pairs[:, 0]] < v[..., pairs[:, 1]]).to(torch.float32)


_RADIUS = PATCH // 2 - 3


def _orb_pairs(n_bits: int) -> np.ndarray:
    return np.stack([np.arange(n_bits) * 2, np.arange(n_bits) * 2 + 1], 1)


def orb_describe(gray: torch.Tensor, kp: Keypoints, n_bits: int = 256) -> torch.Tensor:
    """(B, K, n_bits) oriented-BRIEF descriptors."""
    patches = _extract_patches(gaussian_blur(gray, 2.0), kp.ys, kp.xs)
    return _binary_descriptor(patches, kp.theta, f"brief{n_bits}",
                              lambda: _brief_points(n_bits, radius=_RADIUS),
                              lambda: _orb_pairs(n_bits))


def brisk_describe(gray: torch.Tensor, kp: Keypoints) -> torch.Tensor:
    """(B, K, 512) concentric-pattern binary descriptors."""
    patches = _extract_patches(gaussian_blur(gray, 2.0), kp.ys, kp.xs)
    return _binary_descriptor(patches, kp.theta, "brisk",
                              lambda: _brisk_points_pairs(_RADIUS)[0],
                              lambda: _brisk_points_pairs(_RADIUS)[1])


_SIFT_N, _SIFT_SPAN = 18, 20.0  # 16 x 16 samples + a 1-pixel halo, over 20 px


def _sift_points() -> np.ndarray:
    lin = (np.arange(_SIFT_N, dtype=np.float32) / (_SIFT_N - 1) - 0.5) * _SIFT_SPAN
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return np.stack([gy.reshape(-1), gx.reshape(-1)], 1)


def _sift_weight() -> torch.Tensor:
    g = torch.arange(16, dtype=torch.float32) - 7.5
    return torch.exp(-(g[:, None] ** 2 + g[None, :] ** 2) / (2 * 6.0**2))


def sift_describe(gray: torch.Tensor, kp: Keypoints) -> torch.Tensor:
    """(B, K, 128) SIFT-style descriptors: 4x4 cells x 8 orientation bins
    over an oriented 16 x 16 sample grid, Gaussian-weighted, L2-normalized
    with the 0.2 clip and renormalization."""
    patches = _extract_patches(gaussian_blur(gray, 1.0), kp.ys, kp.xs)
    vals = _oriented_patch_values(patches, kp.theta, "sift", _sift_points)
    grid = vals.reshape(vals.shape[0], vals.shape[1], _SIFT_N, _SIFT_N)
    dx = grid[..., 1:-1, 2:] - grid[..., 1:-1, :-2]
    dy = grid[..., 2:, 1:-1] - grid[..., :-2, 1:-1]  # (B, K, 16, 16)
    mag = torch.sqrt(dx * dx + dy * dy) * device_constant("sift_weight", gray.device,
                                                          _sift_weight)
    ang = torch.remainder(torch.atan2(dy, dx), 2 * math.pi)
    bins = torch.clamp((ang / (2 * math.pi) * 8).to(torch.int32), 0, 7)
    votes = F.one_hot(bins.long(), 8).to(torch.float32) * mag[..., None]
    bk = votes.shape[:2]
    desc = votes.reshape(*bk, 4, 4, 4, 4, 8).sum(dim=(3, 5)).reshape(*bk, 128)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-7)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-7)


_DESCRIBE = {"orb": orb_describe, "sift": sift_describe, "brisk": brisk_describe}


def _describe_one_level(gray: torch.Tensor, kind: str, k: int):
    if kind not in _DESCRIBE:
        raise ValueError(f"unknown corner descriptor {kind!r}")
    kp = detect(gray, max_keypoints=k)
    return _DESCRIBE[kind](gray, kp), kp.valid


def _level_budgets(max_keypoints: int, n_levels: int, scale_step: float):
    """Per-octave keypoint budgets, proportional to the level's area (as
    cv2's ORB spreads nfeatures), summing to ``max_keypoints`` with a floor
    of 8 per level."""
    if max_keypoints < 1:
        raise ValueError(f"max_keypoints must be >= 1, got {max_keypoints}")
    if max_keypoints <= 8:
        return [max_keypoints]
    n_levels = max(1, min(n_levels, max_keypoints // 8))
    w = np.asarray([scale_step ** (-2.0 * lvl) for lvl in range(n_levels)])
    k = np.maximum(np.floor(max_keypoints * w / w.sum()).astype(int), 8)
    while int(k.sum()) > max_keypoints and k.size > 1:
        k[int(np.argmax(k))] -= int(k.sum()) - max_keypoints
        k = np.maximum(k, 8)
        if int(k.sum()) > max_keypoints and (k == 8).all():
            k = k[:-1]  # drop the last octave entirely
    k[0] += max_keypoints - int(k.sum())
    return [int(v) for v in k]


def pyramid_levels(h: int, w: int, max_keypoints: int, n_levels: int = 4,
                   scale_step: float = 1.25):
    """[((height, width), keypoints)] of :func:`detect_and_describe`'s
    pyramid over (h, w) images: each octave ``scale_step`` smaller, until a
    level is too small for the patch and the detector's border, with an
    area-proportional share of ``max_keypoints``; one level when only the
    first fits."""
    min_side = 2 * (PATCH // 2 + 1) + 8
    sizes = []
    for lvl in range(n_levels):
        hl, wl = int(round(h / scale_step**lvl)), int(round(w / scale_step**lvl))
        if min(hl, wl) < min_side:
            break
        sizes.append((hl, wl))
    if len(sizes) <= 1:
        return [((h, w), max_keypoints)]
    return list(zip(sizes, _level_budgets(max_keypoints, len(sizes), scale_step)))


def detect_and_describe(gray: torch.Tensor, kind: str, max_keypoints: int = 256,
                        n_levels: int = 4, scale_step: float = 1.25):
    """cv2 ``detectAndCompute``'s counterpart, fixed-shape and multi-scale:
    each level of :func:`pyramid_levels` resizes the (B, H, W) batch
    (``resize_gray``, the JAX package's bilinear weights) and detects and
    describes at that resolution with its share of the keypoint budget.
    Returns (descriptors (B, K, D) f32, valid (B, K) bool)."""
    levels = pyramid_levels(*gray.shape[1:], max_keypoints, n_levels, scale_step)
    outs = [_describe_one_level(resize_gray(gray, hl, wl), kind, k) for (hl, wl), k in levels]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([d for d, _ in outs], dim=1), torch.cat([v for _, v in outs], dim=1)
