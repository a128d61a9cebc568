"""Compute ops on torch tensors: distances, the two-phase exact top-k and
its CUDA kernels, image preprocessing."""


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x`` (shared pad helper)."""
    return ((x + m - 1) // m) * m
