"""The benchmark is driven by data: every piece is found by name in a file
of its own, and a new cell, mix or metric is a file added, not an edit."""

import json
import shutil

import pytest

from portbench import registry
from portbench.run import BENCHMARK_JSON, run_cell
from portbench.tests.small import CELLS, SECONDS


def test_every_piece_of_benchmark_json_has_its_file():
    bench = registry.benchmark(BENCHMARK_JSON)
    for c in bench["configs"]:
        assert (BENCHMARK_JSON.parent / c["file"]).is_file()
        assert registry.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        registry.entry(cell["mix"]["entry"])
        assert cell["limits"], "every cell names the numbers that decide correct"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_per_layer_one():
    bench = registry.benchmark(BENCHMARK_JSON)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.metrics_for(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(bench, w["name"], True)


def test_a_cell_a_mix_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    """A copy of the benchmark's files with one cell, one mix and one
    metric added, and no file edited: the new cell runs on the CPU with
    its own mix and reports its own metric."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "q64-k5.json").write_text(json.dumps(
        {**registry.traffic("q4096"), "queries_per_call": 64, "k": 5, "query_batches": 2,
         "sample_calls": 2}))
    (root / "workloads" / "exact-1m-d128-bf16.q64-k5.json").write_text(json.dumps(
        {"config": "exact-1m-d128-bf16", "traffic": "q64-k5", "params": {},
         "limits": registry.cell("exact-1m-d128-bf16.q4096")["limits"]}))
    (root / "metrics" / "calls_per_s.batch.py").write_text(
        "def read(ctx):\n    return ctx.window.counts['searches'] / ctx.window.window_s\n")
    assert all(p.read_bytes() == b for p, b in before.items())
    bench = registry.benchmark(BENCHMARK_JSON)
    cell = "exact-1m-d128-bf16.q64-k5"
    bench["workloads"].append({"name": cell, "config": "exact-1m-d128-bf16",
                               "traffic": "q64-k5", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls_per_s.batch", "unit": "calls/s",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "search_qps", "workloads": [cell]})
    assert registry.cell(cell, root)["mix"]["k"] == 5
    for trace, name in ((False, "search_qps"), (True, "calls_per_s.batch")):
        run = run_cell(cell, 5, SECONDS, trace, "cpu", root=root, bench=bench,
                       overrides={"config": CELLS["exact-1m-d128-bf16.q4096"]["config"]})
        assert run["result"]["correct"]
        assert run["result"]["metrics"][name]["value"] > 0


def test_an_unknown_name_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric")


def test_names_units_and_paths_keep_to_the_contract():
    import re

    bench = registry.benchmark(BENCHMARK_JSON)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(name.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for p in registry.ROOT.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(registry.ROOT.parent)))
    assert len(BENCHMARK_JSON.read_bytes()) <= 64 * 1024
