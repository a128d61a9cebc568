"""The general traffic generator: what a mix's parameters make of a seed.

An open loop's requests arrive on a schedule fixed before the window:
``arrivals`` is ``poisson`` at ``rate_per_s``. Every seed gets the same
number of requests, ``rate * seconds``, placed uniformly at random in the
window, which is a Poisson process held to that count: seeds then differ
in the order and spacing of the work, not in its amount. Each request names an item of the
input pool, drawn uniformly. A closed loop needs no schedule: its callers
cycle through the pool in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import data


@dataclass
class Schedule:
    due_s: np.ndarray  # (n,) seconds after the window opens, ascending
    item: np.ndarray  # (n,) index into the input pool


def open_loop(mix: dict, seconds: float, pool: int, seed: int) -> Schedule:
    rate = float(mix["rate_per_s"])
    rng = data.numpy_rng(seed, data.SCHEDULE)
    kind = mix.get("arrivals", "poisson")
    if kind != "poisson":
        raise ValueError(f"unknown arrivals {kind!r}")
    n = int(round(rate * seconds))
    due = np.sort(rng.uniform(0.0, seconds, n))
    return Schedule(due_s=due, item=rng.integers(0, pool, n))


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``min(k, n)`` distinct indices of ``range(n)``, drawn from the seed,
    ascending: the answers a run keeps for its comparison."""
    rng = data.numpy_rng(seed, data.SAMPLE)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
