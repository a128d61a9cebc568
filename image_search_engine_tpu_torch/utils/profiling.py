"""Tracing, stage timings and serving metrics.

Port of the JAX package's ``utils/profiling.py``:

  * ``trace()``: a context manager around ``torch.profiler`` (CPU
    activity, and CUDA where a device is there) that writes a Chrome trace
    of the enclosed region into ``log_dir`` (open it in Perfetto or
    ``chrome://tracing``); it yields the profiler, whose ``key_averages()``
    give the region's operators by host and device time;
  * ``StageTimer``: wall-clock totals per named stage;
  * ``ServingStats``: the rolling QPS / latency percentiles and
    certificate-escalation count exposed at GET /stats.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: str | Path = "ise_trace", enabled: bool = True):
    """Profile the enclosed region; on exit its Chrome trace goes to
    ``log_dir/trace_<pid>_<ns>.json``. Yields the ``torch.profiler.profile``
    (None when not enabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the region's device work inside the trace
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulates wall-clock per named stage: ``with t.stage("embed"): ...``"""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1e3 * v / self.counts[k], 3)}
            for k, v in self.totals.items()
        }


class ServingStats:
    """Rolling request latency / QPS counters (thread-safe)."""

    def __init__(self, window: int = 1024):
        self._lat = deque(maxlen=window)
        self._count = 0
        self._errors = 0
        self._escalations = 0
        self._t0 = time.time()
        self._lock = threading.Lock()

    def record(self, latency_s: float, error: bool = False) -> None:
        with self._lock:
            self._count += 1
            if error:
                self._errors += 1
            else:
                self._lat.append(latency_s)

    def record_escalation(self, n: int = 1) -> None:
        """Count queries whose exactness certificate failed and were
        re-dispatched at the wide candidate margin (serving/fused.py) —
        surfaced at /stats so escalations are operator-visible, not
        log-only."""
        with self._lock:
            self._escalations += int(n)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
            n = len(lat)
            up = time.time() - self._t0

            def pct(p: float) -> Optional[float]:
                if not n:
                    return None
                return round(1e3 * lat[min(int(p * n), n - 1)], 2)

            return {
                "requests": self._count,
                "errors": self._errors,
                "certificate_escalations": self._escalations,
                "uptime_s": round(up, 1),
                "qps_lifetime": round(self._count / max(up, 1e-9), 2),
                "latency_ms_p50": pct(0.50),
                "latency_ms_p90": pct(0.90),
                "latency_ms_p99": pct(0.99),
            }
