"""Batched image preprocessing on the device.

Port of the CNN half of ``image_search_engine_tpu/ops/image_ops.py``
(the gray/HSV ops go with BoVW, ROADMAP.md queue 1 item 5). Images
are NHWC at every public function, as in the JAX package: float32 RGB in
[0, 1] or uint8 in [0, 255], shape (B, H, W, 3) or (H, W, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: (device, dtype) -> (mean, std) tensors, made by the first eager call on
#: that device: a dispatch captured as a CUDA graph may not upload them
#: (a pageable host-to-device copy waits for the stream)
_IMAGENET_TENSORS: dict = {}


def to_unit_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [0, 1]. uint8 / 255 in f32
    is bit-identical to the host decoder's ``np.float32(im) / 255``."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 255.0
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
    key = (img.device, img.dtype)
    if key not in _IMAGENET_TENSORS:
        _IMAGENET_TENSORS[key] = (torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device),
                                  torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device))
    mean, std = _IMAGENET_TENSORS[key]
    return (img - mean) / std


def preprocess_for_cnn(img: torch.Tensor, size: int = 224) -> torch.Tensor:
    """resize to (size, size) + ImageNet normalization, the input of the
    torchvision-layout backbones (BiT's ``"unit"`` normalization comes
    with BiT, ROADMAP.md queue 1 item 6)."""
    return normalize_imagenet(resize(img, size, size))
