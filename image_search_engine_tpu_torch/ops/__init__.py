"""Compute ops on torch tensors: distances, the two-phase exact top-k and
its CUDA kernels, image preprocessing, the local descriptors, BoVW's
histograms and BM25, dHash."""

from typing import Callable

import torch

#: (name, device) -> tensor: the constants of the descriptor and serving
#: ops, made once per device by the first eager call. A dispatch captured
#: as a CUDA graph may not upload them (a pageable host-to-device copy
#: cannot be captured), and its warm run comes first.
_DEVICE_CONSTANTS: dict = {}


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x`` (shared pad helper)."""
    return ((x + m - 1) // m) * m


def device_constant(name, device, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The constant ``name`` on ``device``: ``make()`` (a CPU tensor) moved
    there at the first call for that device, the same tensor since.
    ``name`` is any hashable key that fixes the constant's value."""
    key = (name, torch.device(device))
    t = _DEVICE_CONSTANTS.get(key)
    if t is None:
        t = _DEVICE_CONSTANTS[key] = make().to(device)
    return t
