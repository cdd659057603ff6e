"""Dry runs on the CPU: every cell cut to a tiny size runs through
set-up, window, trace readers and check; a cell added as data files
alone runs; the command refuses a machine without a card and a checkout
without the program; a planted fault and the control come out not
correct. The window's numbers here are CPU numbers and mean nothing."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cellbench import calibrate, faults, harness
from cellbench.tests.tiny import REPO, make_root, tiny_name

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 17


def _quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("cellbench"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_cell_runs_dry(root, cell, trace):
    r = harness.run_cell(tiny_name(cell), SEED, 0.2, trace, "cpu", root,
                         log=_quiet)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    c = harness.resolve(tiny_name(cell), root)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # the CPU has no card: the shares of a card's peak are left out
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    assert set(r["check"]) == set(c.traffic["limits"])
    json.dumps(r)


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in (root / "cellbench").rglob("*") if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A new configuration and traffic mix, and entries in BENCHMARK.json:
    no file that was there changes, and the new cell resolves and runs."""
    root = make_root(tmp_path)
    before = _digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "cellbench/configs/unet_effb0.json")
                      .read_text())
    conf["name"] = "unet_effb0_x2"
    (root / "cellbench/configs/unet_effb0_x2.json").write_text(
        json.dumps(conf))
    t = json.loads((root / "cellbench/traffic/pseudo_label.x3.bs64_512.tiny"
                    ".json").read_text())
    t.update(members=2, check_batches=1)
    (root / "cellbench/traffic/pseudo_label.x2.tiny.json").write_text(
        json.dumps(t))
    bench["configs"].append({"name": "unet_effb0_x2",
                             "source": "https://arxiv.org/abs/1905.11946",
                             "file": "cellbench/configs/unet_effb0_x2.json",
                             "reduced": [], "why": "two members"})
    bench["workloads"].append({"name": "pseudo_label.effb0x2.tiny",
                               "config": "unet_effb0_x2",
                               "traffic": "pseudo_label.x2.tiny",
                               "chips": 1, "why": "two members"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pseudo_label.effb0x3.bs64_512.tiny" in m.get("workloads", []):
            m["workloads"].append("pseudo_label.effb0x2.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        r = harness.run_cell("pseudo_label.effb0x2.tiny", SEED, 0.2, trace,
                             "cpu", root, log=_quiet)
        assert r["correct"] is True
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "cellbench/configs/unet_effb0_x2.json",
        "cellbench/traffic/pseudo_label.x2.tiny.json"}


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and cellbench/: the driver cannot import the
    program, and no result comes out."""
    root = make_root(tmp_path)
    os.unlink(root / "cartseg_tpu_torch")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pathlib import Path; from cellbench import harness; "
            "harness.run_cell(sys.argv[2], 1, 0.1, False, 'cpu', "
            "Path(sys.argv[1]), log=lambda m: None); print('{}')")
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code, str(root),
                          tiny_name(CELLS[0])], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{}" not in out.stdout
    assert "cartseg_tpu_torch" in out.stderr
    shutil.rmtree(root)


FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in faults.FAULTS[json.loads(
                   (REPO / "cellbench/traffic"
                    / f"{next(w['traffic'] for w in BENCH['workloads'] if w['name'] == cell)}.json")
                   .read_text())["driver"]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    r = harness.run_cell(tiny_name(cell), SEED, 0.2, False, "cpu", root,
                         log=_quiet,
                         hook=lambda ctx: faults.plant(ctx, fault))
    assert r["correct"] is False, r["check"]
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    """The reference at fp8 (and its Canny and ABL stages at bf16) in the
    program's place breaks a limit."""
    c = harness.resolve(tiny_name(cell), root)
    numbers = calibrate._control(c, SEED, 0.2, CPU)
    limits = c.traffic["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    """Each cell as committed, at its own size, for a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(cell, SEED, 2.0, False, "cuda", log=_quiet)
    assert r["correct"] is True, r["check"]
