"""The trace's reduction: busy time is the union of device operations
inside the marked window, idle gaps go to the innermost host event."""

import pytest

from portbench.trace import summarize


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_time_idle_gaps_and_graph_launches():
    s = summarize([
        _x("user_annotation", "portbench.trace_start", 0, 1),
        _x("user_annotation", "portbench.trace_end", 1000, 1),
        _x("kernel", "k1", -50, 100),  # clipped to the window
        _x("kernel", "k2", 100, 200),
        _x("kernel", "k3", 250, 100),  # overlaps k2
        _x("gpu_memcpy", "Memcpy HtoD", 600, 100),
        _x("cpu_op", "aten::copy_", 340, 400),
        _x("cuda_runtime", "cudaStreamSynchronize", 350, 300),
        _x("cuda_runtime", "cudaGraphLaunch", 90, 5),
        _x("cuda_runtime", "cudaGraphLaunch", 1200, 5),  # after the window
    ])
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((50 + 250 + 100) * 1e-6)
    assert s.graph_launches == 1
    assert dict(s.device_ops)["k2"] == pytest.approx(200e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(250e-6)  # 350-600, inside copy_
    assert gaps["host: no event"] == pytest.approx((50 + 300) * 1e-6)
