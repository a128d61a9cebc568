"""Finds the benchmark's pieces by name, each in a file of its own:

- ``configs/<config>.json``: a configuration, the sizes as run;
- ``traffic/<mix>.json``: a traffic mix, the parameters that the general
  generator (``portbench/schedule.py``) and the entry that it drives read;
- ``workloads/<cell>.json``: a cell, naming its configuration and mix, the
  parameters it sets over the mix's, and the limit of each number that
  decides ``correct``;
- ``metrics/<metric>.py``: the reader of one metric, ``read(ctx)``;
- ``entries/<entry>.py``: how a mix drives one entry point of the program.

A later cell, mix or metric is a file added here; no file is edited.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent


def _json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file named {name!r} under {root}")
    return json.loads(path.read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root, "traffic", name)


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's file, with ``mix``: the traffic file's parameters under
    the cell's ``params``."""
    c = _json(root, "workloads", name)
    c["name"] = name
    c["mix"] = {**traffic(c["traffic"], root), **c.get("params", {})}
    return c


def entry(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "entries", name)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(ctx) -> float | None`` of the metric ``name``."""
    return _module(root, "metrics", name).read


def _module(root: Path, kind: str, name: str) -> ModuleType:
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} under {root}")
    if Path(root).resolve() == ROOT and "." not in name:
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics with ``trace`` off, its per-layer metrics with it on. A metric
    without ``workloads`` is every cell's (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]
