"""Segmentation metrics on the device (counterpart of
cartseg_tpu/metrics.py): NHWC logits [B,H,W,1] and targets [B,H,W,1] in
{0,1}, reduced per sample over H, W, C. The validation loop takes
weighted SUMS (`eval_suite_sums`, `threshold_sweep_sums`) and divides
once per epoch, so cycle-padded tail samples (weight 0) count nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_SPATIAL = (1, 2, 3)


def eval_suite_per_sample(logits, targets, t: float = 0.5,
                          smooth: float = 1.0,
                          eps: float = 1e-7) -> Dict[str, torch.Tensor]:
    """Every validation metric as a per-sample [B] vector."""
    probs = torch.sigmoid(logits.to(torch.float32))
    targets = targets.to(torch.float32)
    preds = (probs > t).to(torch.float32)

    inter_soft = (probs * targets).sum(_SPATIAL)
    den_soft = probs.sum(_SPATIAL) + targets.sum(_SPATIAL)
    dice = (2.0 * inter_soft + smooth) / (den_soft + smooth + eps)

    tp = (preds * targets).sum(_SPATIAL)
    fp = (preds * (1.0 - targets)).sum(_SPATIAL)
    fn = ((1.0 - preds) * targets).sum(_SPATIAL)
    union = tp + fp + fn
    iou = (tp + eps) / (union + eps)
    dice_b = (2.0 * tp + eps) / (2.0 * tp + fp + fn + eps)
    precision = (tp + eps) / (tp + fp + eps)
    recall = (tp + eps) / (tp + fn + eps)
    f1 = 2.0 * precision * recall / (precision + recall + eps)
    return {"dice": dice, "iou": iou, "dice_bin": dice_b, "iou_bin": iou,
            "precision": precision, "recall": recall, "f1": f1}


def eval_suite_sums(logits, targets, w, t: float = 0.5
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Weighted sums of the per-sample metrics, and the weight total."""
    per = eval_suite_per_sample(logits, targets, t)
    w = w.to(torch.float32)
    return {k: (v * w).sum() for k, v in per.items()}, w.sum()


def threshold_sweep_sums(logits, targets, thresholds: torch.Tensor, w
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binarized (dice_sums [T], iou_sums [T], n) over thresholds [T]:
    one forward, every threshold at once (the reference re-infers the
    val set per threshold, train_bce_dice.py:214-232)."""
    probs = torch.sigmoid(logits.to(torch.float32))
    targets = targets.to(torch.float32)
    w = w.to(torch.float32)
    # [T,B,H,W,1]
    preds = (probs[None] > thresholds.reshape(-1, 1, 1, 1, 1)).to(
        torch.float32)
    axes = (2, 3, 4)
    inter = (preds * targets[None]).sum(axes)
    den = preds.sum(axes) + targets.sum(_SPATIAL)[None]
    union = den - inter
    eps = 1e-7
    dice = (2.0 * inter + eps) / (den + eps)
    iou = (inter + eps) / (union + eps)
    return (dice * w).sum(1), (iou * w).sum(1), w.sum()
