"""No module that the benchmark runs is of the JAX stack or the JAX
package, and the reference takes nothing from the port. Module names
are compared by their top-level part, whole: the port's name,
cartseg_tpu_torch, begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from cellbench import harness
from cellbench.tests.tiny import REPO

PORT = "cartseg_tpu_torch"


def _imports(path):
    """Top-level names of every module a file imports, in any scope."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def _module_file(name):
    rel = REPO.joinpath(*name.split("."))
    for cand in (rel.with_suffix(".py"), rel / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _closure(files):
    """Every module name reachable from `files` through the repo's own
    modules (cellbench and the port), and the files visited."""
    seen, names, todo = set(), set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            names.add(name)
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                mod = _module_file(".".join(parts[:i]))
                if mod is not None:
                    todo.append(mod)
    return names, seen


def _run_files():
    """The files a run loads: cellbench's own modules (not its tests)."""
    return [p for p in (REPO / "cellbench").rglob("*.py")
            if "tests" not in p.relative_to(REPO).parts]


def test_nothing_the_benchmark_runs_names_jax_or_the_jax_package():
    names, _ = _closure(_run_files())
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    assert PORT in tops


def test_the_reference_imports_nothing_of_the_port():
    names, files = _closure(list((REPO / "cellbench/reference").glob("*.py")))
    assert not {n for n in names if n.split(".")[0] == PORT}
    assert all(PORT not in f.parts for f in files)


def test_nothing_reads_the_jax_benchmark():
    for path in _run_files():
        text = path.read_text()
        for old in ("bench.py", "BENCH_", "benchmarks/", "benchmarks."):
            assert old not in text, (path, old)


def test_a_run_holds_no_forbidden_module(tmp_path):
    """A whole run of a cut cell in a fresh interpreter, then sys.modules."""
    from cellbench.tests.tiny import make_root
    root = make_root(tmp_path)
    cell = json.loads((root / "BENCHMARK.json").read_text())["workloads"][0]
    code = (
        "import json, sys, torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from cellbench import harness\n"
        f"r = harness.run_cell({cell['name']!r}, 5, 0.2, False, 'cpu', "
        f"Path({str(root)!r}), log=lambda m: None)\n"
        "print(json.dumps({'held': harness.forbidden_modules(), "
        "'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"held": [], "correct": True}
