"""Serving metrics: ``ServingStats``, the rolling QPS / latency
percentiles and certificate-escalation count exposed at GET /stats.

A copy of ``ServingStats`` from the JAX package's ``utils/profiling.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


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
