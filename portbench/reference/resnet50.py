"""Plain ResNet-50 (v1.5, arXiv:1512.03385 with the stride on the 3x3 conv,
torchvision's layout): the benchmark's reference backbone and its own copy
of the layer shapes.

The forward pass is ``torch.nn.functional`` over a state dict with
torchvision's key names: NHWC images in [0, 1], ImageNet normalization,
conv -> batch norm (running statistics) -> ReLU, the bottlenecks, and the
global average pool to a 2048-d embedding. It runs in float32 with TF32
off for cuDNN and cuBLAS, restoring both flags on exit. With ``fp8=True``
every convolution's input and weight are rounded to float8 e4m3 (each
tensor scaled so its largest magnitude is e4m3's largest finite value)
before an f32 convolution: the lower-precision control of the bf16
backbone. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = (3, 4, 6, 3)  # bottlenecks per stage
EXPANSION = 4
EMBED_DIM = 2048
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3 value


@dataclass(frozen=True)
class Conv:
    """One convolution: its state-dict prefix (``<prefix>.weight``, the
    batch norm at ``bn``), channels, kernel, stride and padding."""

    name: str
    bn: str
    cin: int
    cout: int
    kernel: int
    stride: int
    pad: int


def convs() -> List[Conv]:
    """Every convolution of ResNet-50 in forward order."""
    out = [Conv("conv1", "bn1", 3, 64, 7, 2, 3)]
    inplanes = 64
    for i, blocks in enumerate(STAGES):
        planes = 64 * 2 ** i
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            p = f"layer{i + 1}.{j}"
            out += [Conv(f"{p}.conv1", f"{p}.bn1", inplanes, planes, 1, 1, 0),
                    Conv(f"{p}.conv2", f"{p}.bn2", planes, planes, 3, stride, 1),
                    Conv(f"{p}.conv3", f"{p}.bn3", planes, planes * EXPANSION, 1, 1, 0)]
            if j == 0:
                out.append(Conv(f"{p}.downsample.0", f"{p}.downsample.1", inplanes,
                                planes * EXPANSION, 1, stride, 0))
            inplanes = planes * EXPANSION
    return out


def conv_out(size: int, c: Conv) -> int:
    return (size + 2 * c.pad - c.kernel) // c.stride + 1


def walk(image_size: int = 224) -> List[Tuple[Conv, int, int]]:
    """(conv, input side, output side) of every convolution in forward
    order, at a square input of ``image_size``."""
    table = {c.name: c for c in convs()}
    c1 = table["conv1"]
    out = [(c1, image_size, conv_out(image_size, c1))]
    side = (out[0][2] + 2 - 3) // 2 + 1  # the 3x3 stride-2 max pool, padded by 1
    for i, blocks in enumerate(STAGES):
        for j in range(blocks):
            p = f"layer{i + 1}.{j}"
            s_in = side
            for name in ("conv1", "conv2", "conv3"):
                c = table[f"{p}.{name}"]
                out.append((c, side, conv_out(side, c)))
                side = out[-1][2]
            if j == 0:
                c = table[f"{p}.downsample.0"]
                out.append((c, s_in, conv_out(s_in, c)))
    return out


def macs_per_image(image_size: int = 224) -> int:
    """Multiply-accumulates of one image's convolutions (the pool, batch
    norms and ReLUs are not counted)."""
    return sum(o * o * c.cout * c.cin * c.kernel * c.kernel for c, _, o in walk(image_size))


def flops_per_image(image_size: int = 224) -> int:
    """Operations of one image's forward pass: 2 per multiply-accumulate."""
    return 2 * macs_per_image(image_size)


def param_shapes() -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of the state dict: kind is
    ``conv`` (weight), ``gamma``, ``beta``, ``mean`` or ``var``."""
    out = []
    for c in convs():
        out.append((f"{c.name}.weight", (c.cout, c.cin, c.kernel, c.kernel), "conv"))
        for key, kind in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                          ("running_var", "var")):
            out.append((f"{c.bn}.{key}", (c.cout,), kind))
    return out


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS products, restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class ResNet50:
    """The reference forward pass over ``state_dict`` (any float dtype,
    widened to f32 on ``device``)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], device, fp8: bool = False):
        self.p = {k: v.to(device=device, dtype=torch.float32) for k, v in state_dict.items()}
        self.fp8 = fp8
        self.device = torch.device(device)

    def _conv_bn(self, x: torch.Tensor, c: Conv, relu: bool) -> torch.Tensor:
        w = self.p[f"{c.name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, stride=c.stride, padding=c.pad)
        y = F.batch_norm(y, self.p[f"{c.bn}.running_mean"], self.p[f"{c.bn}.running_var"],
                         self.p[f"{c.bn}.weight"], self.p[f"{c.bn}.bias"], training=False,
                         eps=BN_EPS)
        return torch.relu(y) if relu else y

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] (uint8 is divided by 255) ->
        (B, 2048) f32 embeddings."""
        with ieee_f32():
            x = images.to(self.device)
            if x.dtype == torch.uint8:  # v / 255 rounded once to f32, as a decoder gives it
                x = (torch.arange(256, dtype=torch.float64, device=self.device) / 255.0
                     ).to(torch.float32)[x.long()]
            x = x.to(torch.float32)
            mean = torch.tensor(IMAGENET_MEAN, device=self.device)
            std = torch.tensor(IMAGENET_STD, device=self.device)
            x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
            table = {c.name: c for c in convs()}
            x = self._conv_bn(x, table["conv1"], True)
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for i, blocks in enumerate(STAGES):
                for j in range(blocks):
                    p = f"layer{i + 1}.{j}"
                    y = self._conv_bn(x, table[f"{p}.conv1"], True)
                    y = self._conv_bn(y, table[f"{p}.conv2"], True)
                    y = self._conv_bn(y, table[f"{p}.conv3"], False)
                    res = self._conv_bn(x, table[f"{p}.downsample.0"], False) if j == 0 else x
                    x = torch.relu(y + res)
            return x.mean(dim=(2, 3))

    def embed_blocks(self, images: torch.Tensor, block: int = 64) -> torch.Tensor:
        """:meth:`__call__` over ``block`` images at a time."""
        return torch.cat([self(images[s:s + block]) for s in range(0, images.shape[0], block)])
