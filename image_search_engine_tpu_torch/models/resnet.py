"""ResNet-v1.5 as a ``torch.nn.Module``.

Port of ``image_search_engine_tpu/models/resnet.py``: the global-feature
embedder of the DNN path, returning the post-pool 2048-D vector (no
classifier head). Parameter names follow torchvision (conv1/bn1,
layer{i}.{j}.conv{1,2,3}/bn{1,2,3}, downsample.{0,1}), so a torchvision
ResNet ``state_dict`` loads straight in. NHWC at the public boundary, as the
JAX model takes it; inside, the NCHW view of an NHWC tensor is
``channels_last`` memory, which cuDNN runs without a transpose.

Geometry matches the Flax model: (1, 1) padding on the 3x3 convs, stride
on the 3x3 (v1.5), max pool padded with -inf, BN epsilon 1e-5, and a zero
scale on each block's last BN at random init.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn as nn

# Flax's lecun_normal: truncated normal at +-2 std, rescaled so the
# truncated distribution keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False), nn.BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """(B, H, W, 3) images -> (B, 64 * 2**(stages-1) * 4) f32 features."""

    def __init__(self, stage_sizes: Sequence[int], generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)  # pads with -inf
        inplanes = 64
        self.stage_sizes = tuple(stage_sizes)
        for i, n_blocks in enumerate(self.stage_sizes):
            planes = 64 * 2**i
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, 2 if (i > 0 and j == 0) else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Random init mirroring the Flax model's: lecun-normal convs, unit
        BN scale, zero bias, running mean 0 / var 1, zero scale on each
        block's last BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view in channels_last memory
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3)).float()  # global average pool


ResNet50 = partial(ResNet, (3, 4, 6, 3))
ResNet18Thin = partial(ResNet, (1, 1, 1, 1))  # tiny config for tests
