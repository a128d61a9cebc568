"""The port's keypoint detector and corner descriptors against the JAX
package's on the CPU, on the same seeded 96-px images (32 keypoints, a
2-level pyramid).

Tolerances:
  * Harris responses: 1e-6 of the largest (the port's filters round float64
    sums, the JAX package's convolutions sum in f32);
  * keypoints: positions and ``valid`` equal, equal responses in index
    order (an image whose corners repeat, so responses tie exactly);
    orientations within 1e-4 rad (atan2 of f32 moment sums: a keypoint
    whose m01 nearly cancels moves most, 2.3e-5 here);
  * a keypoint's pattern is sampled at the orientation bin round(32 theta /
    2 pi): keypoints whose 32 theta / 2 pi lies within 1e-3 of a half
    integer (twice the orientation tolerance) may take the neighbouring bin
    and are left out of the descriptor comparison (none is on these
    images);
  * ORB and BRISK bits: equal, but a bit may flip where its two samples
    lie within 1e-5 (none does here);
  * SIFT floats: 1e-5 (unit-norm 128-D).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu import descriptors as jdesc
from image_search_engine_tpu.ops import corners as jc
from image_search_engine_tpu_torch import descriptors as pdesc
from image_search_engine_tpu_torch.ops import corners as pc
from image_search_engine_tpu_torch.ops.image_ops import rgb_to_gray, to_unit_f32

K, LEVELS, SIZE = 32, 2, 96


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def images():
    """4 smooth 96-px RGB uint8 images (seeded 8x8 colour fields upsampled,
    plus noise) and one whose 16-px tile repeats (its corners tie)."""
    rng = np.random.default_rng(0)
    lows = (rng.random((4, 8, 8, 3)) * 255).astype(np.uint8)
    out = [np.clip(np.asarray(Image.fromarray(lo).resize((SIZE, SIZE), Image.BILINEAR),
                              np.float32) + 4 * rng.standard_normal((SIZE, SIZE, 3)), 0, 255)
           for lo in lows]
    tile = np.asarray(Image.fromarray((rng.random((4, 4, 3)) * 255).astype(np.uint8))
                      .resize((16, 16), Image.NEAREST), np.float32)
    out.append(np.tile(tile, (SIZE // 16, SIZE // 16, 1)))
    return np.stack(out).astype(np.uint8)


@pytest.fixture(scope="module")
def gray(images):
    return rgb_to_gray(to_unit_f32(torch.from_numpy(images)))


@pytest.fixture(scope="module")
def jax_described(images):
    """The JAX package's descriptors of the images, computed once (its
    first ORB and SIFT calls compile for seconds)."""
    return {kind: jdesc.CornerDescriptor(kind, K, n_levels=LEVELS).describe_batch(images)
            for kind in ("orb", "sift", "brisk")}


def test_harris_and_keypoints(gray):
    g = gray.numpy()
    want = np.asarray(jc.harris_response(jnp.asarray(g)))
    got = pc.harris_response(gray).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    jk, pk = jc.detect(jnp.asarray(g), K), pc.detect(gray, K)
    for name in ("ys", "xs", "valid"):
        np.testing.assert_array_equal(getattr(pk, name).numpy(), np.asarray(getattr(jk, name)))
    np.testing.assert_allclose(pk.score.numpy(), np.asarray(jk.score),
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(pk.theta.numpy(), np.asarray(jk.theta), atol=1e-4)
    # the repeating image: its kept responses tie in groups, and both
    # packages list equal responses in index order
    tied = pk.score[4][pk.valid[4]].numpy()
    assert len(np.unique(tied)) < len(tied)
    flat = (pk.ys[4] * SIZE + pk.xs[4]).numpy()
    for v in np.unique(tied):
        same = flat[:len(tied)][tied == v]
        assert (np.diff(same) > 0).all()


def test_sampling_tables_are_the_jax_matrices():
    """The gather tables hold each column of the JAX package's bf16
    sampling matrices: its four weights at their rows, in row order."""
    for pts in (pc._brief_points(256, 13), pc._brisk_points_pairs(13)[0], pc._sift_points()):
        want = torch.from_numpy(jc._oriented_sample_matrix(pts)).to(torch.bfloat16).float()
        idx, wts = pc._oriented_sample_taps(pts)
        dense = torch.zeros_like(want)
        o = torch.arange(pc.N_ORIENT)[:, None, None].expand_as(idx)
        t = torch.arange(pts.shape[0])[None, :, None].expand_as(idx)
        dense.index_put_((o, idx, t), wts, accumulate=True)
        assert torch.equal(dense, want)
        assert (idx.diff(dim=-1) > 0).all()  # the four rows in increasing order
    np.testing.assert_array_equal(pc._brief_points(256, 13), jc._brief_points(256, 13))
    for a, b in zip(pc._brisk_points_pairs(13), jc._brisk_points_pairs(13)):
        np.testing.assert_array_equal(a, b)


def _pattern_values(kind, gray, kp):
    """The port's sampled pattern values behind each bit."""
    sigma = {"orb": 2.0, "brisk": 2.0}[kind]
    patches = pc._extract_patches(pc.gaussian_blur(gray, sigma), kp.ys, kp.xs)
    if kind == "orb":
        pts, pairs = pc._brief_points(256, 13), pc._orb_pairs(256)
    else:
        pts, pairs = pc._brisk_points_pairs(13)
    v = pc._oriented_patch_values(patches, kp.theta, "test_" + kind, lambda: pts)
    return v[..., pairs[:, 0]] - v[..., pairs[:, 1]]


def _levels(gray):
    """Each pyramid level's gray images and keypoints, as the port detects."""
    levels = pc.pyramid_levels(SIZE, SIZE, K, LEVELS)
    assert [hw for hw, _ in levels] == [(SIZE, SIZE), (77, 77)]
    out = []
    for (h, w), k in levels:
        g = pc.resize_gray(gray, h, w)
        out.append((g, pc.detect(g, k)))
    return out


@pytest.mark.parametrize("kind", ["orb", "brisk", "sift"])
def test_pyramid_descriptors_match(images, gray, jax_described, kind):
    want_d, want_v = jax_described[kind]
    got_d, got_v = pdesc.CornerDescriptor(kind, K, n_levels=LEVELS,
                                          device="cpu").describe_batch(images)
    assert got_d.shape == want_d.shape == (5, K, {"orb": 256, "brisk": 512, "sift": 128}[kind])
    np.testing.assert_array_equal(got_v, want_v)
    d2, v2 = pc.detect_and_describe(gray, kind, K, n_levels=LEVELS)
    np.testing.assert_array_equal(d2.numpy(), got_d)
    np.testing.assert_array_equal(v2.numpy(), got_v)
    levels = _levels(gray)
    theta = torch.cat([kp.theta for _, kp in levels], dim=1).numpy()
    frac = theta * pc.N_ORIENT / (2 * math.pi)
    at_edge = np.abs(frac - np.floor(frac) - 0.5) < 1e-3
    keep = ~at_edge
    if kind == "sift":
        np.testing.assert_allclose(got_d[keep], want_d[keep], atol=1e-5)
        return
    diff = got_d != want_d
    gap = torch.cat([_pattern_values(kind, g, kp) for g, kp in levels], dim=1).abs().numpy()
    assert (gap[diff & keep[..., None]] <= 1e-5).all()
    assert diff[keep].sum() == 0  # on these images no bit sits at a tie


def test_level_budgets_match():
    for total in (1, 5, 8, 9, 16, 17, 31, 32, 64, 100, 256, 1024):
        for levels in (1, 2, 3, 4, 8):
            for step in (1.2, 1.25, 1.5, 2.0):
                assert pc._level_budgets(total, levels, step) == jc._level_budgets(
                    total, levels, step), (total, levels, step)
    with pytest.raises(ValueError):
        pc._level_budgets(0, 4, 1.25)


def test_single_level_and_small_images(gray):
    """n_levels = 1, and a level below the patch's size ends the pyramid
    (a 48-px image keeps one level)."""
    for n_levels, size in ((1, SIZE), (4, 48)):
        g = gray[:2, :size, :size]
        d, v = pc.detect_and_describe(g, "orb", 16, n_levels=n_levels)
        kp = pc.detect(g, 16)
        assert d.shape == (2, 16, 256)
        np.testing.assert_array_equal(v.numpy(), kp.valid.numpy())
        np.testing.assert_array_equal(d.numpy(), pc.orb_describe(g, kp).numpy())
    with pytest.raises(ValueError, match="unknown corner descriptor"):
        pc.detect_and_describe(gray, "surf", 16)
