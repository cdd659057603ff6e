"""Checkpoints as torch.save files (counterpart of
cartseg_tpu/train/checkpoint.py, whose Orbax trees, :20-50, are JAX
machinery and are not ported):

  * `<out>/<name>.pth`: the best-Dice checkpoint in the reference format
    {epoch, model_state_dict, val_dice, val_iou} (checkpoint.py:76-89;
    train_bce_dice.py:368-374), plus optimizer_state_dict when
    save_optimizer_state is set, as the reference script saves it;
  * `<out>/<name>.threshold.json`: the swept threshold beside it, the
    reference's sidecar convention, which the port's pseudo-labeller
    reads (infer/engine.py `read_threshold_sidecar`);
  * `<out>/<name>.last.pth`: the continuation snapshot for resume.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import torch

from cartseg_tpu_torch.utils.io import write_json


def best_path(out: Path, name: str) -> Path:
    return Path(out) / f"{name}.pth"


def last_path(out: Path, name: str) -> Path:
    return Path(out) / f"{name}.last.pth"


def save(obj: Dict[str, Any], path: Path) -> None:
    """Write to a temporary name and rename, so a run killed mid-write
    never leaves a truncated checkpoint under the real name."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, str(tmp))
    tmp.replace(path)


def to_cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def save_best(path: Path, model: torch.nn.Module, epoch: int,
              val_dice: float, val_iou: float, optimizer_state=None) -> None:
    obj = {"epoch": epoch, "model_state_dict": to_cpu(model.state_dict()),
           "val_dice": val_dice, "val_iou": val_iou}
    if optimizer_state is not None:
        obj["optimizer_state_dict"] = optimizer_state
    save(obj, path)


def load(path: Path) -> Dict[str, Any]:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def sidecar_path(pth: Path) -> Path:
    return Path(pth).with_suffix(".threshold.json")


def save_threshold_sidecar(pth: Path, threshold: float, dice: float,
                           iou: float) -> None:
    """`<name>.threshold.json` beside `<name>.pth`
    (finetune_for_224.py:385-388)."""
    write_json(sidecar_path(pth), {"threshold": float(threshold),
                                   "dice": float(dice), "iou": float(iou)})
