"""Shared workload runner: CLI overrides -> Trainer.fit() (counterpart of
cartseg_tpu/workloads/_runner.py).

The BatchNorm lane comes from CARTSEG_PALLAS_BN, the switch the JAX
package reads (cartseg_tpu/models/norm.py:122-131): "1" or "force"
picks the channel-sums kernel lane, anything else the torch lane. It is
read once, here at the entry point, and handed to the Trainer.

Under torchrun (RANK and WORLD_SIZE in the environment) the entry point
starts the process group (parallel/mesh.py `maybe_initialize_distributed`:
NCCL with a card a rank, gloo on the CPU or a shared card) and the
Trainer trains over it; the group it started is closed at the end:

    torchrun --nproc_per_node 2 -m cartseg_tpu_torch.workloads.train_bce_dice \
        --synthetic --img_size 64 --batch_size 4 --epochs 1 --device cpu
"""

from __future__ import annotations

import os
import sys
from typing import List, Mapping, Optional

import torch.distributed as dist

from cartseg_tpu_torch.parallel import mesh
from cartseg_tpu_torch.train import TrainConfig, Trainer
from cartseg_tpu_torch.train.config import apply_cli_overrides


def bn_lane_from_env(environ: Mapping[str, str] = os.environ) -> str:
    """CARTSEG_PALLAS_BN -> the models' BN lane (norm.py `use_pallas_bn`)."""
    forced = environ.get("CARTSEG_PALLAS_BN", "0") in ("1", "force")
    return "channel_sums" if forced else "torch"


def run(cfg: TrainConfig, argv: Optional[List[str]] = None,
        log=print):
    cfg = apply_cli_overrides(cfg, sys.argv[1:] if argv is None else argv)
    started = (not mesh.is_initialized()
               and mesh.maybe_initialize_distributed(cfg.device, log))
    try:
        result = Trainer(cfg, bn_lane=bn_lane_from_env()).fit(log=log)
    finally:
        if started:
            dist.destroy_process_group()
    if result.get("interrupted"):
        print(f"interrupted after epoch {result['epoch'] + 1} "
              f"best_val_dice={result['best_val_dice']:.4f}")
        return result
    print(f"best_val_dice={result['best_val_dice']:.4f} "
          f"threshold={result['threshold']:.2f} "
          f"images_per_sec={result['images_per_sec']:.1f}")
    return result
