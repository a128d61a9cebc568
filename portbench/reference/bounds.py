"""The yardstick: the H100's published peaks and the least time a piece
of work could take on it.

A frozen copy of the repository's chip smoke arithmetic (``bound`` and
``kernel_bounds``): NVIDIA's data sheet for the H100 SXM, dense rates
without sparsity, at the full 700 W power limit. A share of a peak read
on a card set below 700 W is stated beside that card's limit.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
GROUP = 128  # rows per candidate group of the two-phase search


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(nq: int, n: int, d: int, isz: int, ng: int, t: int, rows: int,
                  on_tensor_cores: bool) -> dict:
    """bound() of the two-phase search's group-min sweep and rescore: the
    store (or the ``rows`` distinct candidate rows), norms, queries and
    outputs once; 2 Q N d operations (rescore: 2 Q t 128 d) at the f32
    CUDA-core rate, three times that at the tf32 rate for f32 on tensor
    cores (the 3xTF32 split), once at the bf16 rate for bf16."""
    mult, peak = (1, BF16_FLOPS) if isz == 2 else (3, TF32_FLOPS) if on_tensor_cores else \
        (1, F32_FLOPS)
    return {
        "groupmin": bound(n * d * isz + n * 4 + nq * d * isz + nq * ng * 4,
                          mult * 2 * nq * n * d, peak),
        "rescore": bound(rows * (d * isz + 4) + nq * d * isz + nq * t * (4 + GROUP * 4),
                         mult * 2 * nq * t * GROUP * d, peak),
    }


def search_bound_ms(nq: int, n: int, d: int, k: int, isz: int) -> float:
    """The least time of one exact search of ``nq`` queries over ``n`` x
    ``d`` rows of ``isz`` bytes, whatever kernels do it: the 2 Q N d
    operations of the scores at the bf16 rate, or the store, its norms,
    the queries and the (distance, id) answers moved once, whichever is
    longer."""
    return bound(n * (d * isz + 4) + nq * d * 4 + nq * k * 12, 2 * nq * n * d, BF16_FLOPS)[0]
