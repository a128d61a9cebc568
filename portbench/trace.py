"""The device trace of a steady sub-window of a ``--trace 1`` run.

``torch.profiler`` (CPU and CUDA activities) runs from :meth:`Tracer.start`
to :meth:`Tracer.stop`, which mark the window's ends with
``portbench.trace_start`` / ``portbench.trace_end`` annotations. The trace
is written as Chrome JSON under the run's temporary directory, read back
and deleted. Device operations are the kernels, copies and fills; the
device is busy in the union of their intervals inside the window. Each idle
gap is put down to the innermost host event running at its middle (an op,
a runtime call or an annotation, on any thread).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


@dataclass
class TraceSummary:
    window_s: float  # the traced window, by the trace's clock
    busy_s: float  # union of device operations inside it
    device_ops: List[Tuple[str, float]]  # most device time, by name
    idle_gaps: List[Tuple[str, float]]  # idle time by what the host was doing
    graph_launches: int  # CUDA graph replays launched inside the window
    kernels: int
    counts: Dict[str, float] = field(default_factory=dict)  # the entry's counts in the window


class Tracer:
    """The profiler around the traced sub-window; a no-op when off.

    :meth:`prepare` runs one empty session at set-up, so the profiler's own
    first start is paid there. :meth:`start` and :meth:`stop` enter and
    leave the profiler, :meth:`mark_start` and :meth:`mark_end` bound the
    window inside that and keep the entry's counts at both ends. Start and
    stop only while no other thread drives the device: enabling or
    disabling the trace under concurrent launches has stalled the process."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[TraceSummary] = None
        self._prof = None
        self._counts: Dict[str, float] = {}
        self.started = self.marked = self.ended = False

    def prepare(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled or self.started:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.started = True

    def mark_start(self, counts: Dict[str, float]) -> None:
        from torch.profiler import record_function

        with record_function("portbench.trace_start"):
            pass
        self._counts = dict(counts)
        self.marked = True

    def mark_end(self, counts: Dict[str, float]) -> None:
        from torch.profiler import record_function

        with record_function("portbench.trace_end"):
            pass
        self._counts = {k: counts[k] - self._counts.get(k, 0) for k in counts}
        self.ended = True

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self._prof = None
        self.summary = summarize(events["traceEvents"] if isinstance(events, dict) else events)
        self.summary.counts = self._counts


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[dict]) -> TraceSummary:
    """Reduce Chrome trace events (microsecond ``ts`` / ``dur``) to the
    window's busy time, the top device operations and the idle gaps."""
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("name") in ("portbench.trace_start", "portbench.trace_end")}
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    w0 = marks.get("portbench.trace_start", min(float(e["ts"]) for e in timed))
    w1 = marks.get("portbench.trace_end",
                   max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed))
    dev, host, by_name = [], [], defaultdict(float)
    launches = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                dev.append((a, b))
                by_name[e["name"]] += (b - a) / 1e6
        elif cat in HOST_CATS:
            host.append((s, s + d, e["name"]))
            if e["name"] == "cudaGraphLaunch" and w0 <= s <= w1:
                launches += 1
    busy = _union(dev)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = _label_gaps(gaps, host)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=sum(e - s for s, e in busy) / 1e6,
                        device_ops=[[n[:160], v] for n, v in top_ops],
                        idle_gaps=[[n[:160], v] for n, v in idle[:TOP]],
                        graph_launches=launches, kernels=len(dev))


def _label_gaps(gaps: List[Tuple[float, float]], host: List[Tuple[float, float, str]]
                ) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host event (the latest started
    of those running) at each gap's middle, most first."""
    host = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    heap: List[Tuple[float, float, str]] = []
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for i in order:
        s, e = gaps[i]
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "host: no event"] += (e - s) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
