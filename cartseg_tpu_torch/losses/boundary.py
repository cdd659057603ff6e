"""Signed-distance-field boundary loss
(src/train_with_boundary_loss.py:191-282), counterpart of
cartseg_tpu/losses/boundary.py, fully on the device.

The reference builds SDFs per sample on the CPU with scipy EDT every
step (batch_sdf_from_masks :204-217); here both distance maps come from
the jump-flood EDT (ops/edt.py: the CUDA kernel on the card, its plain
version on the CPU, bit-equal to each other and to JAX's XLA lane). A
train step runs `edt_batch` four times: the GT's and the prediction's
SDF, each inside and outside.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.losses.region import bce_dice_loss
from cartseg_tpu_torch.ops.edt import edt, edt_batch


def signed_distance_map(mask: torch.Tensor) -> torch.Tensor:
    """SDF of one HxW {0,1} mask: negative inside, positive outside, zero
    if the mask is degenerate (all fg or all bg), matching
    `signed_distance_map_np` (train_with_boundary_loss.py:191-202)."""
    mask = mask.to(torch.bool)
    dist_out = torch.where(mask, 0.0, edt(mask))    # distance to fg, outside
    dist_in = torch.where(mask, edt(~mask), 0.0)    # distance to bg, inside
    ok = mask.any() & (~mask).any()
    return torch.where(ok, dist_out - dist_in, 0.0).to(torch.float32)


def batch_sdf(masks: torch.Tensor) -> torch.Tensor:
    """[B,H,W,1] {0,1} -> [B,H,W,1] SDF normalized by max(H,W)
    (train_with_boundary_loss.py:204-217); two `edt_batch` calls."""
    B, H, W, _ = masks.shape
    m = masks[..., 0] > 0.5
    dist_out = torch.where(m, 0.0, edt_batch(m))
    dist_in = torch.where(m, edt_batch(~m), 0.0)
    ok = (m.any(2).any(1) & (~m).any(2).any(1))[:, None, None]
    sdf = torch.where(ok, dist_out - dist_in, 0.0).to(torch.float32)
    return (sdf / max(H, W)).unsqueeze(-1)


def symmetric_boundary_loss(logits, targets, t: float = 0.5,
                            w_gt: float = 1.0, w_pred: float = 0.5,
                            use_abs: bool = True, scale: float = 1.0):
    """SymmetricBoundaryLoss (train_with_boundary_loss.py:225-264):
    |probs * sdf_gt| + |(1-probs) * (-sdf_pred)|, with the prediction's
    SDF built from the binarized probabilities and detached."""
    probs = torch.sigmoid(logits.to(torch.float32))
    sdf_gt = batch_sdf(targets.to(torch.float32))
    pred_mask = (probs > t).to(torch.float32).detach()
    sdf_pred = batch_sdf(pred_mask).detach()

    term_gt = probs * sdf_gt
    term_pred = (1.0 - probs) * (-sdf_pred)
    if use_abs:
        term_gt = term_gt.abs()
        term_pred = term_pred.abs()
    return scale * (w_gt * term_gt.mean() + w_pred * term_pred.mean())


def composite_seg_loss(logits, targets, bce_weight: float = 0.5,
                       boundary_weight: float = 0.3, **sym_kwargs):
    """CompositeSegLoss (train_with_boundary_loss.py:267-282):
    (1-wb)*(BCE+Dice) + wb*SymmetricBoundary."""
    reg = bce_dice_loss(logits, targets, bce_weight=bce_weight)
    bnd = symmetric_boundary_loss(logits, targets, **sym_kwargs)
    return (1.0 - boundary_weight) * reg + boundary_weight * bnd
