"""Run one cell of the port's benchmark once and print its result line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration and
traffic mix; the mix names the entry point it drives (``entries/``). The
run makes its inputs from the seed, sets the program up and warms every
shape the cell uses (``setup_s``: from the process's start to the window's
opening), then measures for ``--seconds``. With ``--trace 1`` the profiler
also records a steady sub-window, and the run reports the cell's per-layer
metrics instead of its end-to-end ones. After the window the program's
state is freed and the reference judges what the window produced: each
number compared is printed beside its limit, as the last lines on standard
error and last in the result line. The last line of standard output is the
result, one JSON object.

The run needs a CUDA device (as many as the cell's ``chips``): without
one it exits with 2 and prints no result. It also exits without a result
(3) if the JAX package, JAX or Flax is loaded in the process when the
result is due: after the window, the reference, the control and every
metric's reader, just before the line would be printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional


from portbench import registry
from portbench.trace import Tracer

_T_IMPORT = time.perf_counter()
BENCHMARK_JSON = Path(__file__).resolve().parent.parent / "BENCHMARK.json"
#: top-level modules that may not be loaded in a run (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "image_search_engine_tpu")
BIG = sys.float_info.max  # stands for an infinite number in the JSON line


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v: float) -> float:
    return v if math.isfinite(v) else BIG


class Ctx:
    """What a metric's reader reads: the cell, its configuration and mix,
    ``setup_s``, the window (``attempted``, ``failed``, ``window_s``,
    ``counts``, ``latencies_s``) and the trace summary, or None."""

    def __init__(self, cell: dict, config: dict, setup_s: float, window, trace):
        self.cell, self.config, self.mix = cell, config, cell["mix"]
        self.setup_s = setup_s
        self.window = window
        self.trace = trace


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, *,
             root: Path = registry.ROOT, bench: Optional[dict] = None,
             overrides: Optional[Dict[str, dict]] = None, control: bool = False) -> dict:
    """One run of ``cell_name`` on ``device``. Returns {"result": the
    result line's object, "notes": lines for standard error, "checks":
    {number: (value, limit)}, "control": the control's numbers when
    ``control``}.
    ``overrides`` = {"config": {...}, "mix": {...}} replaces keys (tests
    run small sizes on the CPU)."""
    import torch

    overrides = overrides or {}
    bench = bench if bench is not None else registry.benchmark(BENCHMARK_JSON)
    cell = registry.cell(cell_name, root)
    cell["mix"].update(overrides.get("mix", {}))
    config = {**registry.config(cell["config"], root), **overrides.get("config", {})}
    dev = torch.device(device)
    entry = registry.entry(cell["mix"]["entry"], root).Entry(config, cell["mix"], seed, dev)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = Tracer(trace and dev.type == "cuda")
    tracer.prepare()
    entry.setup()
    setup_s = process_age_s()
    win = entry.window(seconds, tracer)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    entry.release()
    gc.collect()
    numbers = entry.check()
    limits = cell["limits"]
    checks = {name: (numbers[name], limits[name]) for name in limits}
    correct = all(v <= lim for v, lim in checks.values())
    out_control = entry.control() if control else None

    ctx = Ctx(cell, config, setup_s, win, tracer.summary)
    metrics = {}
    for m in registry.metrics_for(bench, cell_name, trace):
        value = registry.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": dev_info}
    if tracer.summary is not None:
        s = tracer.summary
        dev_info["busy_s"], dev_info["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["checks"] = {n: {"value": _finite(v), "limit": lim} for n, (v, lim) in checks.items()}
    notes = list(win.notes) + [f"setup_s {setup_s:.3f}, window_s {win.window_s:.4f}, "
                               f"counts {json.dumps(win.counts)}"]
    return {"result": result, "notes": notes, "checks": checks, "control": out_control}


def emit(run: dict, out=None, err=None) -> int:
    """Print ``run``'s notes and checks on ``err`` and its result line last
    on ``out``; return 0. Where a forbidden module is loaded by now (by
    the program, the reference or a reader), name it on ``err``, print no
    result and return 3."""
    out, err = out or sys.stdout, err or sys.stderr
    forbidden = forbidden_modules()
    if forbidden:
        print(f"portbench: loaded in the run's process: {', '.join(forbidden)}", file=err)
        return 3
    for line in run["notes"]:
        print(line, file=err)
    print(f"card: {card_line()}", file=err)
    for name, (v, lim) in run["checks"].items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(run["result"]), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = registry.benchmark(BENCHMARK_JSON)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no cell {args.workload!r} in {BENCHMARK_JSON.name}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    return emit(run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         bench=bench))


if __name__ == "__main__":
    sys.exit(main())
