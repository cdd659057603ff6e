"""The harness: resolves a cell by the names in BENCHMARK.json, runs its
driver through set-up, the measured window and the check, and builds
the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by name:

  configs/<config>.json      the model's sizes, its source and `reduced`
  traffic/<traffic>.json     the mix: its `driver`, batch, sizes, pools,
                             the trainer's settings and the check's limits
  drivers/<driver>.py        set-up, window, profiled unit and check of
                             one kind of work (pseudo_label, train)
  metrics/<metric>.py        one per-layer metric: read(ctx) -> value or
                             None where the cell has nothing to read

A cell added as data (a configuration and a traffic mix for an existing
driver, and entries in BENCHMARK.json) needs no edit to any file here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the port was made from, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "cartseg_tpu")
# profiled units (batches or steps) of a traced run's profiler window
PROFILE_UNITS = 4


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell named `workload`: its entry, configuration, traffic mix,
    driver module, and the metrics it reports."""
    bench = load_benchmark(root)
    here = root / "cellbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{entry['traffic']}.json").read_text())
    driver = _load_module(here / "drivers" / f"{traffic['driver']}.py",
                          f"cellbench_driver_{traffic['driver']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload)
             and m["moves"] in e2e_names]
    readers = {m["name"]: _load_module(here / "metrics" / f"{m['name']}.py",
                                       f"cellbench_metric_{m['name']}")
               for m in layer}
    return SimpleNamespace(name=workload, entry=entry, config=config,
                           traffic=traffic, driver=driver, end_to_end=e2e,
                           per_layer=layer, readers=readers)


def device_info(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t_start: Optional[float] = None,
             log: Callable[[str], None] = None, hook=None) -> dict:
    """One run of one cell: set-up, the window, the traced readings where
    asked, the check; returns the result line as a dict. t_start: the
    process's start on the host clock (set-up is counted from it). hook:
    handed to the driver's set-up, which calls it on its context before
    the program's first call (the tests plant faults with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = resolve(workload, root)
    ctx = cell.driver.setup(cell, seed, torch.device(device), log, hook)
    setup_s = time.perf_counter() - t_start
    measured = cell.driver.window(ctx, seconds)
    dev_info = device_info(device, cell.entry["chips"])
    values = dict(measured["metrics"], setup_s=setup_s)
    result = {"correct": False, "attempted": measured["attempted"],
              "failed": measured["failed"]}
    breakdown = None
    if trace:
        # the CPU of a dry run has no device trace to read
        prof = profile_window(ctx, cell) \
            if torch.device(device).type == "cuda" else None
        ctx.profile = prof
        if prof is not None:
            dev_info["busy_s"] = prof["busy_s"]
            dev_info["window_s"] = prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
        ctx.window = measured
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"the {cell.traffic['driver']} driver "
                               f"measured no {m['name']!r}")
            metrics[m["name"]] = _metric(values[m["name"]], m["unit"])
    cell.driver.release(ctx)
    limits = cell.traffic["limits"]
    numbers, wrong = cell.driver.check(ctx, limits)
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = bool(numbers) and all(v <= limits[k] for k, v in numbers.items())
    result["correct"] = ok
    result["failed"] = measured["failed"] + (0 if ok else wrong)
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


def profile_window(ctx, cell) -> Optional[dict]:
    from cellbench.timing import profile_window as window
    unit, sync = cell.driver.profiled_unit(ctx)
    return window(unit, PROFILE_UNITS, sync)
