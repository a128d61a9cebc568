"""BiT (Big Transfer) ResNet-v2 as a ``torch.nn.Module``.

Port of ``image_search_engine_tpu/models/bit.py``: a pre-activation ResNet
with GroupNorm and weight standardization (no running statistics). Parameter
names follow HuggingFace ``BitModel`` (``embedder.convolution``,
``encoder.stages.{i}.layers.{j}.norm1..3 / conv1..3``, ``...downsample.conv``,
``norm``), so a ``google/bit-50`` state dict loads straight in
(``models/weights.py`` strips a ``bit.`` prefix and drops ``pooler.*``).
NHWC at the public boundary.

Geometry, as the Flax model's:

  * every conv pads TF-style SAME, asymmetric at stride 2: along a side of
    n pixels, ``total = max((ceil(n / s) - 1) * s + k - n, 0)``, of which
    ``total // 2`` before (torch's ``padding="same"`` refuses stride 2);
  * weights are standardized at forward time over (I, kh, kw) per output
    channel, biased variance, epsilon 1e-8;
  * the stem max pool pads ZEROS the same way, then pools VALID, so a
    border maximum over negative activations clamps at 0;
  * GroupNorm epsilon 1e-5, 32 groups; the shortcut's downsample reads the
    pre-activated input; a final GroupNorm + ReLU before the pooling;
  * ``pooling="flatten"`` flattens (C, H, W), torch's order.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_search_engine_tpu_torch.models.layers import flax_init_


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor for a TF-SAME k x k window at stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class StdConv2d(nn.Conv2d):
    """Bias-free conv with weight standardization and TF-SAME padding."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, correction=0)
        w = (self.weight - mean) / torch.sqrt(var + 1e-8)
        return F.conv2d(same_pad(x, self.kernel_size[0], self.stride[0]), w, None, self.stride)


class PreActBottleneck(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1, num_groups: int = 32):
        super().__init__()
        out = 4 * filters
        self.downsample = None
        if in_ch != out or stride != 1:
            self.downsample = nn.ModuleDict({"conv": StdConv2d(in_ch, out, 1, stride)})
        self.norm1 = nn.GroupNorm(num_groups, in_ch, eps=1e-5)
        self.conv1 = StdConv2d(in_ch, filters, 1)
        self.norm2 = nn.GroupNorm(num_groups, filters, eps=1e-5)
        self.conv2 = StdConv2d(filters, filters, 3, stride)
        self.norm3 = nn.GroupNorm(num_groups, filters, eps=1e-5)
        self.conv3 = StdConv2d(filters, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(x))
        residual = x if self.downsample is None else self.downsample["conv"](y)
        y = self.conv1(y)
        y = self.conv2(torch.relu(self.norm2(y)))
        y = self.conv3(torch.relu(self.norm3(y)))
        return residual + y


class BiT(nn.Module):
    """(B, H, W, 3) images -> (B, 4 * 64 * width * 2**(stages-1)) f32, or
    the flattened (C, H, W) last feature map with ``pooling="flatten"``."""

    def __init__(self, stage_sizes: Sequence[int], width_factor: int = 1, num_groups: int = 32,
                 pooling: str = "avg", generator: torch.Generator | None = None):
        super().__init__()
        if pooling not in ("avg", "flatten"):
            raise ValueError(f"pooling must be 'avg' or 'flatten', got {pooling!r}")
        self.pooling = pooling
        w = 64 * width_factor
        self.embedder = nn.ModuleDict({"convolution": StdConv2d(3, w, 7, 2)})
        stages, ch = [], w
        for i, n_blocks in enumerate(stage_sizes):
            filters = w * 2**i
            layers = []
            for j in range(n_blocks):
                layers.append(PreActBottleneck(ch, filters, 2 if (i > 0 and j == 0) else 1,
                                               num_groups))
                ch = 4 * filters
            stages.append(nn.ModuleDict({"layers": nn.Sequential(*layers)}))
        self.encoder = nn.ModuleDict({"stages": nn.ModuleList(stages)})
        self.norm = nn.GroupNorm(num_groups, ch, eps=1e-5)
        self.num_features = ch
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embedder["convolution"](x.permute(0, 3, 1, 2))
        x = F.max_pool2d(same_pad(x, 3, 2), 3, stride=2)
        for stage in self.encoder["stages"]:
            x = stage["layers"](x)
        x = torch.relu(self.norm(x))
        if self.pooling == "flatten":
            return x.flatten(1).float()
        return x.mean(dim=(2, 3)).float()


BiT50 = partial(BiT, (3, 4, 6, 3))
BiTTiny = partial(BiT, (1, 1))  # tests
