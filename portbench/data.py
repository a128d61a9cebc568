"""Everything a run feeds the program, made from ``--seed``: the backbone's
weights, images, and the near-duplicate corpus rows. The same seed gives
the same tensors. Each kind of draw has a stream of its own (``subseed``),
so that drawing one never moves another; large tensors are drawn on the
device, in a few calls."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import resnet50 as R

#: the independent streams drawn from one seed
WEIGHTS, IMAGES, ROWS, SCHEDULE, SAMPLE = 1, 2, 3, 4, 5
ROW_BLOCK = 1 << 15  # corpus rows per draw: each block has a generator of its own


def subseed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64, spawn_key=tuple(stream))
    hi, lo = (int(v) for v in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & (2 ** 63 - 1)


def generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *stream))


def numpy_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *stream))


def resnet50_weights(seed: int, device, dtype=torch.bfloat16, init: Dict | None = None
                     ) -> Dict[str, torch.Tensor]:
    """A ResNet-50 state dict in torchvision's layout, in ``dtype`` on
    ``device``: He-normal convolutions, and batch norms whose scale, shift
    and running statistics are drawn around the identity by ``init``'s
    spreads (``gamma``, ``gamma_last`` for each bottleneck's last norm,
    ``beta``, ``mean``, ``var``). Two draws: one for every convolution,
    one for every norm."""
    init = init or {}
    shapes = R.param_shapes()
    g = generator(seed, WEIGHTS, device=device)
    convs = [(k, s) for k, s, kind in shapes if kind == "conv"]
    norms = [(k, s, kind) for k, s, kind in shapes if kind != "conv"]
    w = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    b = torch.randn(sum(math.prod(s) for _, s, _ in norms), generator=g, device=device)
    sd, off = {}, 0
    for key, shape in convs:
        n = math.prod(shape)
        fan_in = n // shape[0]
        sd[key] = (w[off:off + n].view(shape) * math.sqrt(2.0 / fan_in)).to(dtype)
        off += n
    off = 0
    for key, shape, kind in norms:
        n = shape[0]
        z = b[off:off + n]
        off += n
        if kind == "gamma":
            last = key.endswith("bn3.weight")
            base = init.get("gamma_last", 0.25) if last else 1.0
            v = base * (1.0 + init.get("gamma", 0.1) * z)
        elif kind == "beta":
            v = init.get("beta", 0.05) * z
        elif kind == "mean":
            v = init.get("mean", 0.05) * z
        else:
            v = torch.exp(init.get("var", 0.2) * z)
        sd[key] = v.to(dtype)
    return sd


def images(seed: int, n: int, size: int, device, stream: int = 0) -> torch.Tensor:
    """(n, size, size, 3) uint8 images on ``device``: a random 7 x 7 colour
    grid each, upsampled bilinearly, plus pixel noise of +-12 levels,
    so each image is smooth like a photograph and unlike every other."""
    g = generator(seed, IMAGES, stream, device=device)
    grid = torch.rand((n, 3, 7, 7), generator=g, device=device) * 255.0
    noise = (torch.rand((n, 3, size, size), generator=g, device=device) - 0.5) * 24.0
    up = F.interpolate(grid, size=(size, size), mode="bilinear", align_corners=False)
    return (up + noise).clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def near_dup_blocks(anchors: torch.Tensor, n: int, seed: int, spread: Tuple[float, float]
                    ) -> Iterator[Tuple[int, torch.Tensor]]:
    """The corpus, ``ROW_BLOCK`` rows at a time: (first row id, (rows, d)
    f32) on the anchors' device. Each row is a near duplicate of a random
    anchor a: a + s |a| u, with u Gaussian of unit expected norm and s
    log-uniform in ``spread``, so every query image finds rows at every
    distance from its own embedding, the nearest a few per cent away."""
    dev = anchors.device
    a = anchors.to(torch.float32)
    norm = a.norm(dim=1)
    lo, hi = spread
    for b, start in enumerate(range(0, n, ROW_BLOCK)):
        rows = min(ROW_BLOCK, n - start)
        g = generator(seed, ROWS, b, device=dev)
        which = torch.randint(a.shape[0], (rows,), generator=g, device=dev)
        s = lo * (hi / lo) ** torch.rand(rows, generator=g, device=dev)
        u = torch.randn((rows, a.shape[1]), generator=g, device=dev) / math.sqrt(a.shape[1])
        yield start, a[which] + (s * norm[which])[:, None] * u


def near_dup_rows(anchors: torch.Tensor, n: int, seed: int, spread: Tuple[float, float]
                  ) -> torch.Tensor:
    """:func:`near_dup_blocks` written into one (n, d) f32 tensor."""
    out = torch.empty((n, anchors.shape[1]), dtype=torch.float32, device=anchors.device)
    for start, block in near_dup_blocks(anchors, n, seed, spread):
        out[start:start + block.shape[0]] = block
    return out
