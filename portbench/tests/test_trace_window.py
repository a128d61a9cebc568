"""Where a run starts, marks and stops its trace (a stand-in tracer on the
CPU): once each, in order, with work counted between the marks."""

import pytest

from portbench.run import run_cell
from portbench.tests.small import CELLS


class FakeTracer:
    enabled = True

    def __init__(self):
        self.calls = []
        self.started = self.marked = self.ended = False
        self.summary = None

    def prepare(self):
        self.calls.append("prepare")

    def start(self):
        self.calls.append("start")
        self.started = True

    def mark_start(self, counts):
        self.calls.append("mark_start")
        self.marked = True
        self.at = dict(counts)

    def mark_end(self, counts):
        self.calls.append("mark_end")
        self.ended = True
        self.counts = {k: counts[k] - self.at.get(k, 0) for k in counts}

    def stop(self):
        self.calls.append("stop")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_trace_is_started_marked_and_stopped_once(monkeypatch, cell):
    import portbench.run as run

    made = []
    monkeypatch.setattr(run, "Tracer", lambda enabled: made.append(FakeTracer()) or made[-1])
    over = {"config": CELLS[cell]["config"], "mix": {**CELLS[cell]["mix"], "trace_seconds": 0.5}}
    run_cell(cell, 3, 3.0, True, "cpu", overrides=over)
    t = made[0]
    assert t.calls == ["prepare", "start", "mark_start", "mark_end", "stop"]
    assert sum(t.counts.values()) > 0
