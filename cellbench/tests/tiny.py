"""A copy of the benchmark whose cells are cut to a size the CPU runs in
seconds: every cell of BENCHMARK.json again, at batch 2 of 64 x 64
frames, each with a traffic file of its own, beside a link to the port.
The tests drive it with the harness's device set to the CPU."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"batch": 2, "size": 64, "blob_grid": 8, "mask_grid": 4}


def tiny_name(name: str) -> str:
    return f"{name}.tiny"


def make_root(tmp: Path, compute_dtype: str = "float32") -> Path:
    """tmp/root: BENCHMARK.json with each cell renamed `<name>.tiny` on a
    traffic mix `<traffic>.tiny` (the cell's own at TINY sizes, the
    trainer computing in `compute_dtype`), cellbench/ copied, and the
    port linked."""
    root = tmp / "root"
    shutil.copytree(REPO / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "cartseg_tpu_torch", root / "cartseg_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {w["name"]: tiny_name(w["name"]) for w in bench["workloads"]}
    traffic_dir = root / "cellbench" / "traffic"
    for w in bench["workloads"]:
        t = json.loads((traffic_dir / f"{w['traffic']}.json").read_text())
        t.update({k: v for k, v in TINY.items() if k in t})
        if "trainer" in t:
            t["trainer"]["compute_dtype"] = compute_dtype
        w["traffic"] = tiny_name(w["traffic"])
        (traffic_dir / f"{w['traffic']}.json").write_text(json.dumps(t))
        w["name"] = names[w["name"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[n] for n in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
