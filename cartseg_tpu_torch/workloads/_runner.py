"""Shared workload runner: CLI overrides -> Trainer.fit() (counterpart of
cartseg_tpu/workloads/_runner.py).

The BatchNorm lane comes from CARTSEG_PALLAS_BN, the switch the JAX
package reads (cartseg_tpu/models/norm.py:122-131): "1" or "force"
picks the channel-sums kernel lane, anything else the torch lane. It is
read once, here at the entry point, and handed to the Trainer.
"""

from __future__ import annotations

import os
import sys
from typing import List, Mapping, Optional

from cartseg_tpu_torch.train import TrainConfig, Trainer
from cartseg_tpu_torch.train.config import apply_cli_overrides


def bn_lane_from_env(environ: Mapping[str, str] = os.environ) -> str:
    """CARTSEG_PALLAS_BN -> the models' BN lane (norm.py `use_pallas_bn`)."""
    forced = environ.get("CARTSEG_PALLAS_BN", "0") in ("1", "force")
    return "channel_sums" if forced else "torch"


def run(cfg: TrainConfig, argv: Optional[List[str]] = None,
        log=print):
    cfg = apply_cli_overrides(cfg, sys.argv[1:] if argv is None else argv)
    result = Trainer(cfg, bn_lane=bn_lane_from_env()).fit(log=log)
    if result.get("interrupted"):
        print(f"interrupted after epoch {result['epoch'] + 1} "
              f"best_val_dice={result['best_val_dice']:.4f}")
        return result
    print(f"best_val_dice={result['best_val_dice']:.4f} "
          f"threshold={result['threshold']:.2f} "
          f"images_per_sec={result['images_per_sec']:.1f}")
    return result
