"""Shared workload runner: CLI overrides -> Trainer.fit() (counterpart of
cartseg_tpu/workloads/_runner.py)."""

from __future__ import annotations

import sys
from typing import List, Optional

from cartseg_tpu_torch.train import TrainConfig, Trainer
from cartseg_tpu_torch.train.config import apply_cli_overrides


def run(cfg: TrainConfig, argv: Optional[List[str]] = None,
        log=print):
    cfg = apply_cli_overrides(cfg, sys.argv[1:] if argv is None else argv)
    result = Trainer(cfg).fit(log=log)
    if result.get("interrupted"):
        print(f"interrupted after epoch {result['epoch'] + 1} "
              f"best_val_dice={result['best_val_dice']:.4f}")
        return result
    print(f"best_val_dice={result['best_val_dice']:.4f} "
          f"threshold={result['threshold']:.2f} "
          f"images_per_sec={result['images_per_sec']:.1f}")
    return result
