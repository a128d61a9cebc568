"""The port's profiling helpers on the CPU: ``trace`` writes a Chrome
trace of the enclosed region through ``torch.profiler`` and yields the
profiler; ``StageTimer`` sums wall time per stage, with the JAX package's
summary layout."""

import json
import time

import torch

from image_search_engine_tpu.utils.profiling import StageTimer as JaxStageTimer
from image_search_engine_tpu_torch.utils.profiling import StageTimer, trace


def test_trace_writes_a_chrome_trace_of_the_region(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "t") as prof:
        y = torch.mm(x, x).relu()
    assert y.shape == (64, 64)
    (out,) = (tmp_path / "t").glob("trace_*.json")
    events = json.loads(out.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
    ops = {e.key: e for e in prof.key_averages()}
    assert ops["aten::mm"].count == 1


def test_trace_disabled_writes_nothing(tmp_path):
    with trace(tmp_path / "off", enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None and not (tmp_path / "off").exists()


def test_stage_timer_sums_each_stage_like_the_jax_one():
    timers = (StageTimer(), JaxStageTimer())
    for t in timers:
        for name in ("decode", "embed", "decode"):
            with t.stage(name):
                time.sleep(0.002)
    port, jax_one = (t.summary() for t in timers)
    assert port.keys() == jax_one.keys() == {"decode", "embed"}
    for k in port:
        assert port[k].keys() == jax_one[k].keys() == {"total_s", "count", "mean_ms"}
        assert port[k]["count"] == jax_one[k]["count"] == (2 if k == "decode" else 1)
        assert port[k]["total_s"] >= 0.002 * port[k]["count"]
        raw = timers[0].totals[k]
        assert abs(port[k]["total_s"] - raw) <= 5e-5
        assert abs(port[k]["mean_ms"] - 1e3 * raw / port[k]["count"]) <= 5e-4
