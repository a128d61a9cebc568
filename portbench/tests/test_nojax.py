"""Nothing under portbench imports JAX, Flax or the JAX package (the
top-level name compared whole: the port's begins with the JAX package's),
and nothing it runs reads a benchmark script: neither the top-level
``bench.py`` and ``benchmarks/`` nor the port's twins of them."""

import ast

from portbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "image_search_engine_tpu"}


def _tree(path):
    return ast.parse(path.read_text(), str(path))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _code_strings(tree):
    """String constants other than docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    for path in registry.ROOT.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(_tree(path))}
        if tops & FORBIDDEN:
            found[str(path)] = sorted(tops & FORBIDDEN)
    assert not found


def test_nothing_reads_a_benchmark_script():
    for path in registry.ROOT.rglob("*.py"):
        if "tests" in path.relative_to(registry.ROOT).parts:
            continue
        tree = _tree(path)
        for name in _imports(tree):
            assert not name.startswith(("image_search_engine_tpu_torch.bench",
                                        "benchmarks", "bench")), (path, name)
        for s in _code_strings(tree):
            assert "benchmarks" not in s and "bench.py" not in s, (path, s)


SNEAKY = '''
import io, json, sys
sys.path.insert(0, sys.argv[2])
from portbench.run import emit, run_cell
from portbench.tests.small import CELLS, SECONDS
cell = "exact-1m-d128-bf16.q4096"
for root, bench in (("{portbench}", None), (sys.argv[1], json.loads(sys.argv[3]))):
    out, err = io.StringIO(), io.StringIO()
    rc = emit(run_cell(cell, 5, SECONDS, False, "cpu", root=root, bench=bench,
                       overrides=CELLS[cell]), out, err)
    print(json.dumps({"rc": rc, "out": out.getvalue(), "err": err.getvalue()}))
'''


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A metric's reader added as a file imports a module named ``jax`` (a
    stub on the path) after the window: the run names it and prints no
    result, where the same run with the cell's own readers prints one."""
    import json
    import shutil
    import subprocess
    import sys

    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "workloads", "entries", "metrics"):
        shutil.copytree(registry.ROOT / kind, root / kind)
    (root / "metrics" / "sneaky_s.py").write_text("def read(ctx):\n    import jax\n"
                                                  "    return 1.0\n")
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    bench = registry.benchmark(registry.ROOT.parent / "BENCHMARK.json")
    bench["end_to_end"].append({"name": "sneaky_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    code = SNEAKY.replace("{portbench}", str(registry.ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(root), str(tmp_path / "stubs"),
                           json.dumps(bench)], capture_output=True, text=True, timeout=300,
                          cwd=registry.ROOT.parent)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (sound, sneaky) = [json.loads(line) for line in proc.stdout.splitlines()[-2:]]
    assert sound["rc"] == 0 and json.loads(sound["out"].splitlines()[-1])["correct"]
    assert sneaky["rc"] == 3 and sneaky["out"] == "" and "jax" in sneaky["err"]
