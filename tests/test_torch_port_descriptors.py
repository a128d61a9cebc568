"""The port's image ops, filters and dense descriptors against the JAX
package's on the CPU, on the same seeded numpy inputs.

Tolerances (absolute, images in [0, 1]):
  * gray, HSV, blur, Sobel: 1e-6 (the port rounds float64 sums of the same
    weights, the JAX package sums in f32; a few f32 ulps); resize 5e-6;
  * gradients, masks, HSV histograms: equal (elementwise, or counts of 0/1
    weights);
  * DAISY 1e-7 (l1-normalized 136-D, entries ~1e-2); HOG and the colour
    descriptor 1e-6; the colour-moment hash 1e-3 of each feature's scale
    (its f32 central moments cancel, in both packages);
  * the HOG bins of pixels whose f32 ``atan2`` lies at a bin edge may differ
    (none does on these images).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu import descriptors as jdesc
from image_search_engine_tpu.config import Config as JaxConfig
from image_search_engine_tpu.config import CornerDescriptorKind as JaxKind
from image_search_engine_tpu.config import Method as JaxMethod
from image_search_engine_tpu.ops import color_moment_hash as jcmh
from image_search_engine_tpu.ops import daisy as jdaisy
from image_search_engine_tpu.ops import filters as jf
from image_search_engine_tpu.ops import hog as jhog
from image_search_engine_tpu.ops import image_ops as jio
from image_search_engine_tpu_torch import descriptors as pdesc
from image_search_engine_tpu_torch.config import Config, CornerDescriptorKind, Method
from image_search_engine_tpu_torch.ops import color_moment_hash as pcmh
from image_search_engine_tpu_torch.ops import daisy as pdaisy
from image_search_engine_tpu_torch.ops import filters as pf
from image_search_engine_tpu_torch.ops import hog as phog
from image_search_engine_tpu_torch.ops import image_ops as pio


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def smooth_images(rng, n, size):
    """n smooth RGB images in [0, 1]: seeded 8x8 colour fields, upsampled."""
    lows = (rng.random((n, 8, 8, 3)) * 255).astype(np.uint8)
    return np.stack([np.asarray(Image.fromarray(lo).resize((size, size), Image.BILINEAR),
                                np.float32) / 255.0 for lo in lows])


@pytest.fixture(scope="module")
def images():
    """4 smooth and 2 noisy 64-px RGB images, f32 in [0, 1]."""
    rng = np.random.default_rng(0)
    return np.concatenate([smooth_images(rng, 4, 64),
                           rng.random((2, 64, 64, 3)).astype(np.float32)])


def close(got: torch.Tensor, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_gray_hsv_and_masks(images):
    # uint8 -> [0, 1]: numpy's quotients bit for bit (a table on every device)
    np.testing.assert_array_equal(pio.to_unit_f32(torch.arange(256, dtype=torch.uint8)).numpy(),
                                  np.arange(256, dtype=np.float32) / np.float32(255.0))
    x = torch.from_numpy(images)
    close(pio.rgb_to_gray(x), jio.rgb_to_gray(jnp.asarray(images)), 1e-6)
    hsv = jio.rgb_to_hsv(jnp.asarray(images))
    close(pio.rgb_to_hsv(x), hsv, 1e-6 * 360)
    # grey pixels (c = 0) and pure primaries hit every branch of the hue
    edge = np.array([[[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0],
                      [0.2, 0.9, 0.9]]], np.float32)
    close(pio.rgb_to_hsv(torch.from_numpy(edge)), jio.rgb_to_hsv(jnp.asarray(edge)), 1e-6)
    for h, w in ((64, 64), (31, 48)):
        np.testing.assert_array_equal(pio.five_region_masks(h, w).numpy(),
                                      np.asarray(jio.five_region_masks(h, w)))
    masks = jio.five_region_masks(64, 64)
    got = pio.hsv_histogram_3d(torch.from_numpy(np.array(hsv))[:, None],
                               torch.from_numpy(np.array(masks))[None])
    for b in range(images.shape[0]):
        for m in range(5):
            np.testing.assert_allclose(got[b, m].numpy(),
                                       np.asarray(jio.hsv_histogram_3d(hsv[b], masks[m])),
                                       atol=1e-7)


@pytest.mark.parametrize("src,dst", [(224, (8, 9)), (224, (179, 179)), (224, (143, 115)),
                                     (64, (51, 51)), (32, (40, 41))])
def test_resize_gray_matches_jax_image_resize(src, dst):
    g = np.random.default_rng(src).random((2, src, src)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(g), (2,) + dst, method="bilinear")
    t = torch.from_numpy(g)
    # 5e-6: the JAX package's f32 contraction is 3.5e-6 from float64 at 224
    # -> 179 on these values in [0, 1]; the port's float64 one 1.2e-7
    close(pio.resize_gray(t, *dst), want, 5e-6)
    assert pio.resize_gray(t, src, src) is t


@pytest.mark.parametrize("n,r", [(7, 3), (5, 6), (3, 10), (1, 4), (40, 54)])
def test_reflect_index_beyond_the_size(n, r):
    """numpy's and jnp.pad's reflect padding, reflecting again where the
    pad exceeds the axis (torch's F.pad refuses such pads)."""
    want = np.asarray(jnp.pad(jnp.arange(n), r, mode="reflect"))
    np.testing.assert_array_equal(pf.reflect_index(n, r), want)


@pytest.mark.parametrize("shape,sigma,radius", [
    ((3, 40, 40), 1.0, None), ((3, 40, 40), 1.5, None), ((2, 24, 31), 2.0, None),
    # the pad (60, 54) exceeds the 40-px axes: reflected again
    ((3, 40, 40), 20.0, None), ((2, 8, 40, 40), 17.9, 54), ((1, 6, 5), 3.0, 9)])
def test_gaussian_blur_with_pads_beyond_the_size(shape, sigma, radius):
    x = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    close(pf.gaussian_kernel_1d(sigma, radius), jf.gaussian_kernel_1d(sigma, radius), 1e-7)
    close(pf.gaussian_blur(torch.from_numpy(x), sigma, radius),
          jf.gaussian_blur(jnp.asarray(x), sigma, radius), 1e-6)


def test_sobel_and_gradients(images):
    g = np.array(jio.rgb_to_gray(jnp.asarray(images)))
    for got, want in zip(pf.sobel(torch.from_numpy(g)), jf.sobel(jnp.asarray(g))):
        close(got, want, 1e-6)
    for got, want in zip(pf.gradients(torch.from_numpy(g)), jf.gradients(jnp.asarray(g))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,kw", [
    # the default grid on a 40-px image: one centre, its ring offsets wrap
    # and clamp as JAX indexing does, and the blurs pad beyond the size
    (40, {}),
    (64, dict(step=16, radius=16)),
    (64, dict(step=16, radius=16, normalization="l2")),
    (64, dict(step=8, radius=12, rings=3, histograms=6, orientations=4,
              normalization="daisy")),
    (48, dict(step=16, radius=16, normalization="off"))])
def test_daisy(images, size, kw):
    g = np.array(jio.rgb_to_gray(jnp.asarray(images[:3, :size, :size])))
    want = np.asarray(jdaisy.daisy(jnp.asarray(g), **kw))
    got = pdaisy.daisy(torch.from_numpy(g), **kw)
    assert got.shape == want.shape
    close(got, want, 1e-7 if kw.get("normalization", "l1") == "l1" else 1e-6)
    close(pdaisy.daisy(torch.from_numpy(g[0]), **kw), want[0], 1e-6)


@pytest.mark.parametrize("kw", [dict(cell_size=16), dict(cell_size=8, block_size=3,
                                                         orientations=6), {}])
def test_hog(images, kw):
    g = np.array(jio.rgb_to_gray(jnp.asarray(images)))
    want = np.asarray(jhog.hog(jnp.asarray(g), **kw))
    got = phog.hog(torch.from_numpy(g), **kw)
    assert got.shape == want.shape
    close(got, want, 1e-6)


def test_color_moment_hash(images):
    """Both packages sum the central moments in f32, which cancels: each
    feature within 1e-3 of its column's largest magnitude, and the port no
    farther from the same formula in float64 than the JAX package is."""
    want = np.asarray(jcmh.color_moment_hash(jnp.asarray(images)))
    got = pcmh.color_moment_hash(torch.from_numpy(images)).numpy()
    exact = pcmh.color_moment_hash(torch.from_numpy(images).double()).numpy()
    assert got.shape == (6, 42) and got.dtype == np.float32
    scale = np.abs(exact).max(axis=0)
    assert (np.abs(got - want) <= 1e-3 * scale).all()
    assert (np.abs(got - exact) / scale).max() <= max((np.abs(want - exact) / scale).max(), 1e-6)


@pytest.mark.parametrize("name", ["hog", "color", "dhash", "daisy"])
def test_descriptor_classes_match(images, name):
    """describe_batch on uint8 batches, as the indexer hands them over."""
    u8 = (images * 255).astype(np.uint8)
    port, jax_ = {
        "hog": (pdesc.HOGDescriptor(cell_size=16, device="cpu"),
                jdesc.HOGDescriptor(cell_size=16)),
        "color": (pdesc.ColorDescriptor(device="cpu"), jdesc.ColorDescriptor()),
        "dhash": (pdesc.DHashDescriptor(device="cpu"), jdesc.DHashDescriptor()),
        "daisy": (pdesc.DaisyDescriptor(step=16, radius=16, device="cpu"),
                  jdesc.DaisyDescriptor(step=16, radius=16)),
    }[name]
    (gf, gv), (wf, wv) = port.describe_batch(u8), jax_.describe_batch(u8)
    assert port.is_set == jax_.is_set and gf.shape == wf.shape and gf.dtype == wf.dtype
    np.testing.assert_allclose(gf, wf, atol=1e-6)
    if wv is None:
        assert gv is None
    else:
        np.testing.assert_array_equal(gv, wv)


def test_make_descriptor_and_the_cache_key(tmp_path, images):
    """make_descriptor picks what the JAX package's picks; the description
    cache's key is the JAX package's, so either package reads the other's
    cache, and a stale cache (other parameters) is rebuilt."""
    paths = []
    for i, im in enumerate(images):
        paths.append(tmp_path / f"im{i}.png")
        Image.fromarray((im * 255).astype(np.uint8)).save(paths[-1])
    for kind in ("daisy", "orb", "sift", "brisk"):
        for method in ("bovw", "dhash"):
            kw = dict(method=method, corner_descriptor=kind, max_descriptors_per_image=64,
                      corner_n_levels=2, daisy_step=16)
            port = pdesc.make_descriptor(
                Config(**{**kw, "method": Method(method),
                          "corner_descriptor": CornerDescriptorKind(kind)}), device="cpu")
            jax_ = jdesc.make_descriptor(
                JaxConfig(**{**kw, "method": JaxMethod(method),
                             "corner_descriptor": JaxKind(kind)}))
            assert type(port).__name__ == type(jax_).__name__
            key = pdesc.description_key(port, paths, 64)
            assert key == pdesc.description_key(jax_, paths, 64)
    cache = tmp_path / "desc.npz"
    port = pdesc.DaisyDescriptor(step=16, radius=16, device="cpu")
    feats, valid, kept = pdesc.describe_dataset(port, paths, image_size=64, batch_size=4,
                                                cache_path=cache)
    np.testing.assert_array_equal(kept, np.arange(6))
    jf_, jv, jk = jdesc.describe_dataset(jdesc.DaisyDescriptor(step=16, radius=16), paths,
                                         image_size=64, cache_path=cache)
    assert jf_ is not feats and np.array_equal(jf_, feats) and np.array_equal(jk, kept)
    stale = pdesc.DaisyDescriptor(step=32, radius=16, device="cpu")
    f2, _, _ = pdesc.describe_dataset(stale, paths, image_size=64, cache_path=cache)
    assert f2.shape[1] != feats.shape[1]
    with np.load(cache) as z:
        assert str(z["corpus_key"]) == pdesc.description_key(stale, paths, 64)
