"""Siamese embedding model: DenseNet backbone + projection head.

Port of ``image_search_engine_tpu/training/siamese/model.py``. The head is
``[Linear, ReLU, Dropout, BatchNorm1d] x (1024, 512, 256)`` then
``Linear(embedding_dim)``, f32 out. The weights are shared by construction:
one module applied to the concatenated (anchor, positive, negative) batch
in ONE forward (``apply_siamese``), so the head's BatchNorm sees the
statistics of all 3B rows, as the Flax model's does. A frozen backbone runs
in eval mode (its running statistics) and without autograd, whatever
``train()`` is called on the whole net, as the Flax model's
``stop_gradient`` boundary with ``train=False`` below it.

Parameter names: the backbone's torchvision names under ``backbone.``, the
head's ``fc0..fc3`` and ``bn0..bn2``; ``models/weights.state_dict_from_flax
(..., arch="siamese")`` carries the JAX package's variables across. Dropout
draws its keep-masks from an explicit ``torch.Generator`` passed to
``forward``, layer by layer over the rows of the forward
(``draw_masks``); a data-parallel step draws them once for the global
batch and hands each shard its rows (``forward(..., masks=)``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from image_search_engine_tpu_torch.models.densenet import DenseNet121, DenseNetTiny
from image_search_engine_tpu_torch.models.layers import BatchNorm1d, at_least_f32, flax_init_

BACKBONES = {"densenet121": DenseNet121, "densenet-tiny": DenseNetTiny}


class EmbeddingNet(nn.Module):
    """backbone -> (frozen: eval, no autograd) -> MLP head -> D-dim embedding."""

    def __init__(self, embedding_dim: int = 128, head_widths: Sequence[int] = (1024, 512, 256),
                 dropout_rate: float = 0.3, freeze_backbone: bool = True,
                 backbone: str = "densenet121", generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; want {sorted(BACKBONES)}")
        self.backbone = BACKBONES[backbone](generator=generator)
        self.freeze_backbone = freeze_backbone
        self.dropout_rate = dropout_rate
        self.depth = len(head_widths)
        widths = [self.backbone.num_features, *head_widths]
        for i, width in enumerate(head_widths):
            setattr(self, f"fc{i}", nn.Linear(widths[i], width))
            setattr(self, f"bn{i}", BatchNorm1d(width))
        setattr(self, f"fc{self.depth}", nn.Linear(widths[-1], embedding_dim))
        for i in range(self.depth + 1):
            flax_init_(getattr(self, f"fc{i}"), generator)

    def train(self, mode: bool = True) -> "EmbeddingNet":
        super().train(mode)
        if self.freeze_backbone:
            self.backbone.eval()
        return self

    def draw_masks(self, rows: int, generator: torch.Generator | None,
                   device: torch.device) -> list | None:
        """The dropout keep-masks of a training forward over ``rows`` rows,
        one (rows, width) bool tensor a head layer, in the order ``forward``
        draws them; None where dropout is off."""
        if not self.training or self.dropout_rate == 0.0:
            return None
        keep = 1.0 - self.dropout_rate
        return [torch.rand((rows, getattr(self, f"fc{i}").out_features), generator=generator,
                           device=device) < keep for i in range(self.depth)]

    def _dropout(self, y: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        if mask is None:
            return y
        keep = 1.0 - self.dropout_rate
        return torch.where(mask, y / torch.full((), keep, dtype=y.dtype, device=y.device), 0.0)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                masks: list | None = None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, embedding_dim) f32 embeddings. In
        training, dropout uses ``masks`` where given, else draws them from
        ``generator``."""
        if masks is None:
            masks = self.draw_masks(x.shape[0], generator, x.device)
        if self.freeze_backbone:
            with torch.no_grad():
                y = self.backbone(x)
        else:
            y = self.backbone(x)
        for i in range(self.depth):
            y = torch.relu(getattr(self, f"fc{i}")(y))
            y = getattr(self, f"bn{i}")(self._dropout(y, None if masks is None else masks[i]))
        return at_least_f32(getattr(self, f"fc{self.depth}")(y))


def apply_siamese(model: EmbeddingNet, triple, generator: torch.Generator | None = None):
    """Shared-weight application over (anchor, positive[, negative]): one
    forward over the concatenated batch, split back into the triple."""
    out = model(torch.cat(list(triple), dim=0), generator)
    return tuple(torch.chunk(out, len(triple), dim=0))
