"""Region losses (counterpart of cartseg_tpu/losses/region.py): BCE+Dice
and the script-variant focal+Dice, on NHWC logits/targets [B,H,W,1]
(targets in {0,1}), reductions as in the reference:

  * bce_dice_loss        - train_bce_dice.py:186-199
  * bce_dice_per_sample  - finetune_for_224.py:208-221
  * focal_loss           - src/train_with_focalDice.py:195-219
  * focal_dice_loss      - src/train_with_focalDice.py:222-235

The math runs in float32 whatever the autocast dtype of the model: the
inputs are cast first. The CUDA-variant focal loss and the batch
soft-Dice, whose JAX lanes reach Pallas kernels 6 and 7, belong to a
later slice (ROADMAP.md Queue 2).
"""

from __future__ import annotations

import torch

_SPATIAL = (1, 2, 3)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def bce_with_logits(logits, targets, reduction: str = "mean"):
    """max(x,0) - x*y + log(1+exp(-|x|)) (BCEWithLogitsLoss)."""
    logits, targets = _f32(logits), _f32(targets)
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _dice_term(probs, targets, smooth: float):
    inter = (probs * targets).sum(_SPATIAL)
    denom = probs.sum(_SPATIAL) + targets.sum(_SPATIAL)
    return 1.0 - ((2.0 * inter + smooth) / (denom + smooth)).mean()


def bce_dice_loss(logits, targets, bce_weight: float = 0.5,
                  smooth: float = 1.0):
    """w*BCE + (1-w)*(1 - mean soft dice)."""
    logits, targets = _f32(logits), _f32(targets)
    bce = bce_with_logits(logits, targets)
    dice = _dice_term(torch.sigmoid(logits), targets, smooth)
    return bce_weight * bce + (1.0 - bce_weight) * dice


def bce_dice_per_sample(logits, targets, bce_weight: float = 0.5,
                        smooth: float = 1.0):
    """Per-sample [B] BCE+Dice for source-weighted training."""
    logits, targets = _f32(logits), _f32(targets)
    bce = bce_with_logits(logits, targets, reduction="none").mean(_SPATIAL)
    probs = torch.sigmoid(logits)
    inter = (probs * targets).sum(_SPATIAL)
    den = (probs + targets).sum(_SPATIAL)
    dice = 1.0 - (2.0 * inter + smooth) / (den + smooth)
    return bce_weight * bce + (1.0 - bce_weight) * dice


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "mean"):
    """Script-variant focal loss: alpha * (1-pt)^gamma * BCE."""
    logits, targets = _f32(logits), _f32(targets)
    bce = bce_with_logits(logits, targets, reduction="none")
    probs = torch.sigmoid(logits)
    pt = torch.where(targets == 1.0, probs, 1.0 - probs)
    loss = alpha * (1.0 - pt) ** gamma * bce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def focal_dice_loss(logits, targets, alpha: float = 0.5, gamma: float = 2.0,
                    smooth: float = 1.0, w_focal: float = 0.5):
    """w*focal + (1-w)*dice, script semantics."""
    logits, targets = _f32(logits), _f32(targets)
    focal = focal_loss(logits, targets, alpha=alpha, gamma=gamma)
    dice = _dice_term(torch.sigmoid(logits), targets, smooth)
    return w_focal * focal + (1.0 - w_focal) * dice
