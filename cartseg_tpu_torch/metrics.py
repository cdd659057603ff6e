"""Segmentation metrics on the device (counterpart of
cartseg_tpu/metrics.py): NHWC logits [B,H,W,1] and targets [B,H,W,1] in
{0,1}, reduced per sample over H, W, C, then (where a function returns
a batch figure) averaged over the batch. The validation loop takes
weighted SUMS (`eval_suite_sums`, `threshold_sweep_sums`) and divides
once per epoch, so cycle-padded tail samples (weight 0) count nothing;
`workloads/evaluate.py` takes the per-batch means (`eval_suite`,
`threshold_sweep_stats`), as the JAX workload does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_SPATIAL = (1, 2, 3)


def _probs_targets(logits, targets):
    return torch.sigmoid(logits.to(torch.float32)), targets.to(torch.float32)


def soft_dice(logits, targets, smooth: float = 1.0, eps: float = 1e-7):
    """Soft (probability) Dice, the reference's `dice_metric`
    (train_bce_dice.py:201-206)."""
    probs, targets = _probs_targets(logits, targets)
    inter = (probs * targets).sum(_SPATIAL)
    denom = probs.sum(_SPATIAL) + targets.sum(_SPATIAL)
    return ((2.0 * inter + smooth) / (denom + smooth + eps)).mean()


def _binarized(logits, targets, t: float):
    """(tp, sum of preds, sum of targets) per sample at threshold t."""
    probs, targets = _probs_targets(logits, targets)
    preds = (probs > t).to(torch.float32)
    return (preds * targets).sum(_SPATIAL), preds.sum(_SPATIAL), \
        targets.sum(_SPATIAL)


def iou_at(logits, targets, t: float = 0.5, eps: float = 1e-7):
    """Binarized IoU at threshold t (train_bce_dice.py:208-212)."""
    inter, p, g = _binarized(logits, targets, t)
    return ((inter + eps) / (p + g - inter + eps)).mean()


def dice_iou_at(logits, targets, t: float = 0.5, eps: float = 1e-7):
    """Binarized (Dice, IoU) at threshold t — the reference's
    `dice_iou_at_t` (finetune_for_224.py:224-232)."""
    inter, p, g = _binarized(logits, targets, t)
    den = p + g
    dice = (2.0 * inter + eps) / (den + eps)
    iou = (inter + eps) / (den - inter + eps)
    return dice.mean(), iou.mean()


def binary_dice_at(logits, targets, t: float, smooth: float = 1.0):
    """Binarized Dice with +smooth in numerator and denominator, the
    reference's threshold search (train_bce_dice.py:224-227)."""
    inter, p, g = _binarized(logits, targets, t)
    return ((2.0 * inter + smooth) / (p + g + smooth)).mean()


def precision_recall_f1(logits, targets, t: float = 0.5, eps: float = 1e-7):
    """Pixel precision, recall and F1 at threshold t
    (train_with_pretrained.py:218-236)."""
    probs, targets = _probs_targets(logits, targets)
    preds = (probs > t).to(torch.float32)
    tp = (preds * targets).sum(_SPATIAL)
    fp = (preds * (1.0 - targets)).sum(_SPATIAL)
    fn = ((1.0 - preds) * targets).sum(_SPATIAL)
    precision = (tp + eps) / (tp + fp + eps)
    recall = (tp + eps) / (tp + fn + eps)
    f1 = 2.0 * precision * recall / (precision + recall + eps)
    return precision.mean(), recall.mean(), f1.mean()


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


def eval_suite(logits, targets, t: float = 0.5) -> Dict[str, torch.Tensor]:
    """Every validation metric, averaged over the batch."""
    return {k: v.mean() for k, v in
            eval_suite_per_sample(logits, targets, t).items()}


def eval_suite_sums(logits, targets, w, t: float = 0.5
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Weighted sums of the per-sample metrics, and the weight total."""
    per = eval_suite_per_sample(logits, targets, t)
    w = w.to(torch.float32)
    return {k: (v * w).sum() for k, v in per.items()}, w.sum()


def _sweep_sums(logits, targets, thresholds):
    """Per threshold and sample: (tp, sum of preds + sum of targets),
    each [T,B]. Thresholds are taken as float32, as the JAX sweep
    takes them."""
    probs, targets = _probs_targets(logits, targets)
    t = torch.as_tensor(thresholds, dtype=torch.float32,
                        device=probs.device).reshape(-1, 1, 1, 1, 1)
    preds = (probs[None] > t).to(torch.float32)          # [T,B,H,W,1]
    axes = (2, 3, 4)
    inter = (preds * targets[None]).sum(axes)
    return inter, preds.sum(axes) + targets.sum(_SPATIAL)[None]


def _sweep_dice_iou(logits, targets, thresholds):
    """Binarized (dice, iou) per threshold and sample, each [T,B]."""
    inter, den = _sweep_sums(logits, targets, thresholds)
    eps = 1e-7
    return (2.0 * inter + eps) / (den + eps), \
        (inter + eps) / (den - inter + eps)


def threshold_sweep_sums(logits, targets, thresholds, w
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binarized (dice_sums [T], iou_sums [T], n) over thresholds [T]:
    one forward, every threshold at once (the reference re-infers the
    val set per threshold, train_bce_dice.py:214-232)."""
    dice, iou = _sweep_dice_iou(logits, targets, thresholds)
    w = w.to(torch.float32)
    return (dice * w).sum(1), (iou * w).sum(1), w.sum()


def threshold_sweep_stats(logits, targets, thresholds
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binarized (dice [T], iou [T]) over thresholds, each averaged over
    the batch: one forward for every threshold."""
    dice, iou = _sweep_dice_iou(logits, targets, thresholds)
    return dice.mean(1), iou.mean(1)


def threshold_sweep_dice_smooth(logits, targets, thresholds) -> torch.Tensor:
    """Per threshold, the smoothed binarized Dice of the reference's
    `find_best_threshold` (train_bce_dice.py:214-232), averaged over the
    batch. [T]."""
    inter, den = _sweep_sums(logits, targets, thresholds)
    return ((2.0 * inter + 1.0) / (den + 1.0)).mean(1)
