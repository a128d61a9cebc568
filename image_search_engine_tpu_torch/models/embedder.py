"""Batched CNN embedding extractor.

Port of ``image_search_engine_tpu/models/embedder.py`` over the JAX
package's six backbones: ResNet-50, BiT-50 and DenseNet-121 and their tiny
test variants. Images upload as they come (uint8 batches move 4x fewer
bytes than f32) and are cast, resized and normalized on the device ahead
of the backbone (ImageNet statistics for ResNet and DenseNet, (x - 0.5) /
0.5 for BiT). The
backbone computes in bfloat16 by default, as the JAX embedder does; in
float32 the port turns TF32 off for cuDNN convolutions and cuBLAS
matmuls, so f32 means IEEE f32.

The weights file of ``save`` / ``load`` is the torch state dict
(``torch.save``, read back by ``models/weights.read_state_dict``). The JAX
embedder writes flax msgpack, which the port cannot read without flax; JAX
parameters cross through ``models/weights.state_dict_from_flax``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Mapping

import numpy as np
import torch

from image_search_engine_tpu_torch.models.bit import BiT50, BiTTiny
from image_search_engine_tpu_torch.models.densenet import DenseNet121, DenseNetTiny
from image_search_engine_tpu_torch.models.resnet import ResNet18Thin, ResNet50
from image_search_engine_tpu_torch.models.weights import (
    load_state_dict, load_torch_weights, read_state_dict)
from image_search_engine_tpu_torch.ops.image_ops import preprocess_for_cnn, to_unit_f32
from image_search_engine_tpu_torch.utils.device import resolve_device

# name -> (ctor, embedding dim, input normalization), the JAX package's
MODEL_REGISTRY = {
    "resnet50": (ResNet50, 2048, "imagenet"),
    "bit-50": (BiT50, 2048, "unit"),
    "densenet121": (DenseNet121, 1024, "imagenet"),
    # tiny variants for tests / smoke runs
    "resnet-tiny": (ResNet18Thin, 2048, "imagenet"),
    "bit-tiny": (BiTTiny, 512, "unit"),
    "densenet-tiny": (DenseNetTiny, 32, "imagenet"),
}


def check_model_name(model_name: str) -> None:
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; want {sorted(MODEL_REGISTRY)}")


class CNNEmbedder:
    """Global-feature embedder: images -> (N, D) float32 embeddings."""

    def __init__(
        self,
        model_name: str = "resnet50",
        image_size: int = 224,
        batch_size: int = 64,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        seed: int = 0,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        torch_weights: str | Path | None = None,
    ):
        check_model_name(model_name)
        if state_dict is not None and torch_weights is not None:
            raise ValueError("pass either state_dict or torch_weights, not both")
        self.device = resolve_device(device)
        ctor, self.dim, self.norm_name = MODEL_REGISTRY[model_name]
        self.model_name = model_name
        self.image_size = image_size
        self.batch_size = batch_size
        self.dtype = dtype
        model = ctor(generator=torch.Generator().manual_seed(seed))
        if torch_weights is not None:
            load_torch_weights(model, torch_weights)
        elif state_dict is not None:
            load_state_dict(model, state_dict)
        if dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.eval().to(device=self.device, dtype=dtype,
                                     memory_format=torch.channels_last)

    @torch.inference_mode()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float [0, 1] tensor on the embedder's
        device -> (B, D) float32 embeddings on the device."""
        x = preprocess_for_cnn(to_unit_f32(images), self.image_size, self.norm_name)
        return self.model(x.to(self.dtype))

    def embed_batch(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) host images -> (B, D) host float32, in chunks of
        ``batch_size``."""
        images = np.asarray(images)
        out = np.empty((images.shape[0], self.dim), np.float32)
        for s in range(0, images.shape[0], self.batch_size):
            chunk = torch.from_numpy(images[s:s + self.batch_size]).to(self.device)
            out[s:s + chunk.shape[0]] = self.embed(chunk).cpu().numpy()
        return out

    def embed_iter(self, batches: Iterable[np.ndarray]) -> np.ndarray:
        """Host image batches -> one (N, D) host float32 array."""
        return np.concatenate([self.embed_batch(b) for b in batches])

    def save(self, path: str | Path) -> None:
        """Write the backbone's state dict as held (its dtype), on the CPU."""
        torch.save({k: v.cpu() for k, v in self.model.state_dict().items()}, str(path))

    def load(self, path: str | Path) -> "CNNEmbedder":
        """Load a state dict written by :meth:`save` (or any checkpoint of
        this architecture in its source layout: torchvision, HF BiT)."""
        load_state_dict(self.model, read_state_dict(path))
        return self
