"""Descriptor facade: one batched interface over every feature family.

Port of ``image_search_engine_tpu/descriptors.py``. A descriptor takes a
batch of images and returns fixed-shape arrays; a dataset streams through
in batches (host decode threads, then the device), and the description
cache is a plain ``.npz`` keyed by the corpus and the descriptor's
parameters. Set-type descriptors (corner, DAISY, colour) return (B, K, D)
and a validity mask; global ones (CNN, HOG, dHash) return (B, D) and None.

Each descriptor runs on its ``device`` (CUDA unless the caller asks for the
CPU; it raises when CUDA is asked for and absent). ``describe_device``
(corner and DAISY) is the chain on device tensors that the BoVW serving
dispatch runs; ``describe_batch`` takes and returns host arrays.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.config import Config, CornerDescriptorKind, Method
from image_search_engine_tpu_torch.ops import corners as corner_ops
from image_search_engine_tpu_torch.ops.daisy import daisy
from image_search_engine_tpu_torch.ops.dhash import dhash_bits
from image_search_engine_tpu_torch.ops.hog import hog
from image_search_engine_tpu_torch.ops.image_ops import (
    five_region_masks, hsv_histogram_3d, rgb_to_gray, rgb_to_hsv, to_unit_f32)
from image_search_engine_tpu_torch.utils.device import resolve_device
from image_search_engine_tpu_torch.utils.imageio import load_images_batched

log = logging.getLogger(__name__)


class SupportsDescribeBatch(Protocol):
    """Batched descriptor protocol: one batch of host images in."""

    is_set: bool  # True: (B, K, D) + valid; False: (B, D)

    def describe_batch(self, images: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ...


class _OnDevice:
    """A descriptor computed on ``self._device`` by ``_describe(images)``
    (device tensor in; a tensor, or a (features, valid) pair, out). The
    device is kept under a private name: the description cache's key
    covers the public attributes only, as the JAX package's does."""

    def __init__(self, device):
        self._device = resolve_device(device)

    @torch.inference_mode()
    def describe_batch(self, images):
        out = self._describe(torch.as_tensor(np.asarray(images), device=self._device))
        if isinstance(out, tuple):
            return tuple(t.cpu().numpy() for t in out)
        return out.cpu().numpy(), None


class CornerDescriptor(_OnDevice):
    """ORB / SIFT / BRISK-style keypoint descriptors, fixed K masked, over a
    scale pyramid (ops/corners.py)."""

    is_set = True

    def __init__(self, kind: str | CornerDescriptorKind = "orb", max_keypoints: int = 256,
                 n_levels: int = 4, scale_step: float = 1.25, device="cuda"):
        super().__init__(device)
        self.kind = kind.value if isinstance(kind, CornerDescriptorKind) else kind
        self.max_keypoints = max_keypoints
        self.n_levels = n_levels
        self.scale_step = scale_step

    def describe_device(self, images: torch.Tensor):
        """(B, H, W, 3) images on the device -> (features (B, K, D), valid
        (B, K)): no host copy and no shape that depends on the data, so a
        serving dispatch can be captured around it."""
        gray = rgb_to_gray(to_unit_f32(images))
        return corner_ops.detect_and_describe(gray, self.kind, self.max_keypoints,
                                              n_levels=self.n_levels,
                                              scale_step=self.scale_step)

    _describe = describe_device


class DaisyDescriptor(_OnDevice):
    """Dense-grid DAISY (ops/daisy.py), every grid point valid."""

    is_set = True

    def __init__(self, step: int = 32, radius: int = 32, rings: int = 2, histograms: int = 8,
                 orientations: int = 8, device="cuda"):
        super().__init__(device)
        self.kw = dict(step=step, radius=radius, rings=rings, histograms=histograms,
                       orientations=orientations)

    def describe_device(self, images: torch.Tensor):
        """As :meth:`CornerDescriptor.describe_device`."""
        d = daisy(rgb_to_gray(to_unit_f32(images)), **self.kw)
        return d, torch.ones(d.shape[:2], dtype=torch.bool, device=d.device)

    _describe = describe_device


class HOGDescriptor(_OnDevice):
    """Whole-image HOG vector (ops/hog.py)."""

    is_set = False

    def __init__(self, orientations: int = 9, cell_size: int = 32, block_size: int = 2,
                 device="cuda"):
        super().__init__(device)
        self.kw = dict(orientations=orientations, cell_size=cell_size, block_size=block_size)

    def _describe(self, images):
        return hog(rgb_to_gray(to_unit_f32(images)), **self.kw)


class ColorDescriptor(_OnDevice):
    """Five-region HSV histograms: the four corners minus the centre
    ellipse, then the ellipse; 8 x 12 x 3 bins each."""

    is_set = True

    def __init__(self, bins=(8, 12, 3), device="cuda"):
        super().__init__(device)
        self.bins = tuple(bins)

    def _describe(self, images):
        images = to_unit_f32(images)
        masks = five_region_masks(*images.shape[1:3], device=images.device)  # (5, H, W)
        d = hsv_histogram_3d(rgb_to_hsv(images)[:, None], masks[None], self.bins)
        return d, torch.ones(d.shape[:2], dtype=torch.bool, device=d.device)


class DHashDescriptor(_OnDevice):
    """64-bit difference hash as a 64-D 0/1 vector (ops/dhash.py)."""

    is_set = False

    def __init__(self, device="cuda"):
        super().__init__(device)

    def _describe(self, images):
        return dhash_bits(rgb_to_gray(to_unit_f32(images))).to(torch.float32)


class CNNDescriptorAdapter:
    """CNN embeddings through models/embedder.py."""

    is_set = False

    def __init__(self, embedder):
        self.embedder = embedder

    def describe_batch(self, images):
        return self.embedder.embed_batch(images), None


def make_descriptor(cfg: Config, embedder=None, device="cuda") -> SupportsDescribeBatch:
    """The descriptor the config names (the CNN adapter for ``dnn``, which
    needs ``embedder``), on ``device``."""
    if cfg.method == Method.DNN:
        if embedder is None:
            raise ValueError("the dnn method describes with an embedder")
        return CNNDescriptorAdapter(embedder)
    if cfg.method == Method.DHASH:
        return DHashDescriptor(device=device)
    if cfg.corner_descriptor == CornerDescriptorKind.DAISY:
        return DaisyDescriptor(step=cfg.daisy_step, radius=cfg.daisy_radius, device=device)
    return CornerDescriptor(cfg.corner_descriptor, cfg.max_descriptors_per_image,
                            n_levels=cfg.corner_n_levels, scale_step=cfg.corner_scale_step,
                            device=device)


def _sig(v) -> str:
    """Stable text of a descriptor parameter: objects reduce to their type
    name (an id()-bearing repr would change the key every process)."""
    if isinstance(v, (str, int, float, bool, type(None))):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(_sig(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_sig(x)}" for k, x in sorted(v.items())) + "}"
    return type(v).__name__


def description_key(descriptor, paths: Sequence[str | Path], image_size: int) -> str:
    """The description cache's key: the corpus, the image size and the
    descriptor's type and public parameters (the same kind at another
    pyramid depth, budget or grid describes differently). The JAX package
    computes the same key, so a cache written by either is read by both."""
    params = {k: v for k, v in getattr(descriptor, "__dict__", {}).items()
              if not k.startswith("_")}
    desc_sig = type(descriptor).__name__ + _sig(params)
    return hashlib.sha256(("\n".join(str(p) for p in paths)
                           + f"|{image_size}|{desc_sig}").encode()).hexdigest()


def describe_dataset(
    descriptor: SupportsDescribeBatch,
    paths: Sequence[str | Path],
    image_size: int = 224,
    batch_size: int = 32,
    cache_path: Optional[str | Path] = None,
    use_native: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Describe a whole corpus: (features, valid or None, kept), ``kept``
    the indices of the paths that decoded (unreadable files are skipped).
    With ``cache_path``, a cache whose key matches is read instead, and a
    stale one (another corpus or descriptor parameters) is rebuilt. The
    cache is written uncompressed (``np.savez``; the JAX package compresses
    it, and either reads both): deflating the f32 rows of a corner
    descriptor costs far more than describing them."""
    key = description_key(descriptor, paths, image_size)
    if cache_path is not None and Path(cache_path).exists():
        z = np.load(cache_path, allow_pickle=False)
        if "corpus_key" in z.files and str(z["corpus_key"]) == key:
            log.info("loaded cached descriptions from %s", cache_path)
            return z["features"], (z["valid"] if "valid" in z.files else None), z["kept"]
        log.info("description cache %s is stale (corpus or descriptor params changed); "
                 "rebuilding", cache_path)

    feats, valids, kept = [], [], []
    for batch, idx in load_images_batched(paths, batch_size, (image_size, image_size),
                                          use_native=use_native):
        f, v = descriptor.describe_batch(batch)
        feats.append(f)
        kept.extend(idx)
        if v is not None:
            valids.append(v)
    features = np.concatenate(feats) if feats else np.zeros((0,))
    valid = np.concatenate(valids) if valids else None
    kept = np.asarray(kept, np.int64)

    if cache_path is not None:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        payload = {"features": features, "kept": kept, "corpus_key": np.array(key)}
        if valid is not None:
            payload["valid"] = valid
        np.savez(cache_path, **payload)
    return features, valid, kept
