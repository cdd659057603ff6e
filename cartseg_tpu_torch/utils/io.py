"""Metrics writers (counterpart of cartseg_tpu/utils/io.py, which holds
no JAX) matching the reference's observability artifacts:
per-epoch CSV (train_bce_dice.py:317-320,361-362), JSON history files
(finetune_pseudo_hard_clean.py:209,239-244), and `.threshold.json`
sidecars (finetune_for_224.py:385-388)."""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Sequence


class CSVLogger:
    """Append-per-epoch CSV with a fixed header, created on first use."""

    def __init__(self, path: Path, header: Sequence[str]):
        self.path = Path(path)
        self.header = list(header)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerow(self.header)

    def append(self, row: Dict[str, Any]):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(k, "") for k in self.header])


class JSONHistory:
    """List-of-dicts history persisted after every append."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.items: List[Dict[str, Any]] = []
        if self.path.exists():
            try:
                self.items = json.loads(self.path.read_text())
            except Exception:
                self.items = []

    def append(self, item: Dict[str, Any]):
        self.items.append(item)
        self.path.write_text(json.dumps(self.items, indent=2))


def write_json(path: Path, obj: Any):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2))


def read_json(path: Path, default: Any = None) -> Any:
    path = Path(path)
    if not path.exists():
        return default
    return json.loads(path.read_text())
