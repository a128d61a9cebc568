"""DenseNet as a ``torch.nn.Module``.

Port of ``image_search_engine_tpu/models/densenet.py``: the siamese
backbone (DenseNet-121: growth 32, blocks (6, 12, 24, 16), 1024-D) and a
tiny variant for tests (blocks (2, 2), growth 8, 32-D). Parameter names
follow torchvision (``features.conv0`` / ``norm0``,
``features.denseblock{b}.denselayer{l}.norm1/conv1/norm2/conv2``,
``features.transition{t}.norm/conv``, ``features.norm5``), so a
torchvision ``densenet121`` state dict loads straight in. NHWC at the
public boundary, as the JAX model takes it.

Geometry matches the Flax model: 7x7 stride-2 stem padded by 3, max pool
3x3 stride 2 padded with -inf on both sides, (1, 1) padding on the 3x3
convs, 2x2 average pools in the transitions, BN epsilon 1e-5. The
BatchNorms update their running statistics as Flax does
(``models/layers.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_search_engine_tpu_torch.models.layers import BatchNorm2d, at_least_f32, flax_init_


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        self.norm1 = BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.norm2 = BatchNorm2d(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = BatchNorm2d(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """(B, H, W, 3) images -> (B, features) f32 (1024 for DenseNet-121)."""

    def __init__(self, block_sizes: Sequence[int], growth_rate: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        ch = 2 * growth_rate
        feats = OrderedDict(conv0=nn.Conv2d(3, ch, 7, stride=2, padding=3, bias=False),
                            norm0=BatchNorm2d(ch))
        for b, n_layers in enumerate(block_sizes):
            feats[f"denseblock{b + 1}"] = nn.Sequential(OrderedDict(
                (f"denselayer{l + 1}", DenseLayer(ch + l * growth_rate, growth_rate))
                for l in range(n_layers)))
            ch += n_layers * growth_rate
            if b != len(block_sizes) - 1:
                feats[f"transition{b + 1}"] = Transition(ch, ch // 2)
                ch //= 2
        feats["norm5"] = BatchNorm2d(ch)
        self.features = nn.ModuleDict(feats)
        self.num_features = ch
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view in channels_last memory
        x = F.max_pool2d(torch.relu(f["norm0"](f["conv0"](x))), 3, stride=2, padding=1)
        for name, block in f.items():
            if name.startswith(("denseblock", "transition")):
                x = block(x)
        x = torch.relu(f["norm5"](x))
        return at_least_f32(x.mean(dim=(2, 3)))  # global average pool


DenseNet121 = partial(DenseNet, (6, 12, 24, 16))
DenseNetTiny = partial(DenseNet, (2, 2), growth_rate=8)  # tests
