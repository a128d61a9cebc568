"""How a traffic mix drives one entry point of the program. A mix names its
entry (``"entry"``); each module here has ``Entry(config, mix, seed,
device)`` with ``setup()``, ``window(seconds, tracer) -> Window``,
``release()``, ``check() -> {number: value}`` and ``control() -> {number:
value}`` (the same numbers with the lower-precision control in the
program's place)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Window:
    attempted: int
    failed: int
    window_s: float  # from the window's opening to its last answer
    counts: Dict[str, float] = field(default_factory=dict)  # over the whole window
    latencies_s: Optional[np.ndarray] = None  # per request, inf where it failed
    notes: List[str] = field(default_factory=list)  # printed on standard error


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TraceSpan:
    """Traces ``length_s`` from the middle of a closed loop's window: call
    :meth:`tick` between units of work (no other thread drives the device
    then) with the running counts; ``clock()`` gives the seconds since the
    window opened. The window is marked once the profiler has started, so
    its start-up stays outside."""

    def __init__(self, tracer, seconds: float, length_s: float, clock):
        self.tracer, self.clock = tracer, clock
        self.length_s = min(length_s, seconds / 2)
        self.start_s = (seconds - self.length_s) / 2
        self.end_s = None

    def tick(self, counts: Dict[str, float]) -> None:
        t = self.tracer
        if not t.enabled or t.ended:
            return
        if not t.started and self.clock() >= self.start_s:
            t.start()
            t.mark_start(counts)
            self.end_s = self.clock() + self.length_s
        elif t.marked and self.clock() >= self.end_s:
            self.finish(counts)

    def finish(self, counts: Dict[str, float]) -> None:
        t = self.tracer
        if t.marked and not t.ended:
            t.mark_end(counts)
            t.stop()


def now() -> float:
    return time.perf_counter()
