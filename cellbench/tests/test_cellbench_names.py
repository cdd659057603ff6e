"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the contract's shapes. CPU only:

    python -m pytest --noconftest cellbench/tests
"""

import json
import re

import pytest

from cellbench import harness
from cellbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(c.readers[m["name"]].read)
    assert callable(c.driver.setup) and callable(c.driver.check)
    assert c.traffic["limits"], "the check holds at least one number"


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "bound" not in m
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert c["file"].startswith("cellbench/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_file_is_named_from_a_name():
    for path in (REPO / "cellbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
