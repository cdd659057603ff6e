"""Region losses (counterpart of cartseg_tpu/losses/region.py): BCE+Dice
and the script-variant focal+Dice, on NHWC logits/targets [B,H,W,1]
(targets in {0,1}), reductions as in the reference:

  * bce_dice_loss        - train_bce_dice.py:186-199
  * bce_dice_per_sample  - finetune_for_224.py:208-221
  * focal_loss           - src/train_with_focalDice.py:195-219
  * focal_loss_kernel    - focal_kernel.cu:30-52 (CUDA variant:
                           -|y-p|^gamma * [y*a*log p + (1-y)(1-a)*log(1-p)])
  * focal_dice_loss      - src/train_with_focalDice.py:222-235
  * soft_dice_loss       - soft_dice_kernel_v2.cu:53-160 (per-sample
                           1 - (2*sum(p*y)+s)/(sum(p^pexp)+sum(y)+s))

The math runs in float32 whatever the autocast dtype of the model: the
inputs are cast first. `focal_loss_kernel` and `soft_dice_loss` are
autograd Functions over the hand-written CUDA kernels of the JAX
package's Pallas kernels `_fused_kernel` and `_reduce_kernel` (ROADMAP
Queue 2 #7 and #8; ops/cuda/focal.py, ops/cuda/soft_dice.py) on the
card, and over their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.focal import focal_fwd
from cartseg_tpu_torch.ops.cuda.soft_dice import soft_dice_sums

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


class _FocalLossKernel(torch.autograd.Function):
    """focal.py `focal_pallas`: one pass writes the loss and its
    gradient; the backward multiplies the saved gradient by g and casts
    it to the logits' dtype (focal.py:86-97)."""

    @staticmethod
    def forward(ctx, logits, targets, gamma, alpha):
        x = _f32(logits).contiguous()
        y = _f32(targets).contiguous()
        loss, grad = focal_fwd(x, y, gamma, alpha)
        ctx.save_for_backward(grad)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return (g * grad).to(ctx.dtype), None, None, None


def focal_loss_kernel(logits, targets, gamma: float = 2.0,
                      alpha: float = 0.25):
    """Elementwise (unreduced) CUDA-variant focal loss, float32, with the
    hand-derived gradient of focal_kernel.cu:55-90."""
    return _FocalLossKernel.apply(logits, targets, gamma, alpha)


def focal_dice_loss(logits, targets, alpha: float = 0.5, gamma: float = 2.0,
                    smooth: float = 1.0, w_focal: float = 0.5):
    """w*focal + (1-w)*dice, script semantics."""
    logits, targets = _f32(logits), _f32(targets)
    focal = focal_loss(logits, targets, alpha=alpha, gamma=gamma)
    dice = _dice_term(torch.sigmoid(logits), targets, smooth)
    return w_focal * focal + (1.0 - w_focal) * dice


class _SoftDice(torch.autograd.Function):
    """soft_dice.py `soft_dice_pallas`: the per-sample sums by the kernel,
    the analytic backward in plain torch (soft_dice.py:101-113)."""

    @staticmethod
    def forward(ctx, logits, labels, p, smooth):
        B = logits.shape[0]
        x = _f32(logits).reshape(B, -1).contiguous()
        y = _f32(labels).reshape(B, -1).contiguous()
        numer, denor = soft_dice_sums(x, y, p)
        ctx.save_for_backward(logits, labels, numer, denor)
        ctx.p, ctx.smooth = p, smooth
        return 1.0 - (numer + smooth) / (denor + smooth)

    @staticmethod
    def backward(ctx, g):
        logits, labels, numer, denor = ctx.saved_tensors
        p, smooth = ctx.p, ctx.smooth
        x, y = _f32(logits), _f32(labels)
        bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
        N = (numer + smooth).reshape(bshape)
        D = (denor + smooth).reshape(bshape)
        prob = torch.sigmoid(x)
        dprob = prob * (1.0 - prob)
        # d loss / d prob = -(2y*D - N*p*prob^(p-1)) / D^2
        dl_dprob = -(2.0 * y * D - N * p * prob ** (p - 1.0)) / (D * D)
        grad = dl_dprob * dprob * _f32(g).reshape(bshape)
        return grad.to(logits.dtype), None, None, None


def soft_dice_loss(logits, labels, p: float = 1.0, smooth: float = 1.0):
    """Batch soft-Dice with the soft_dice_kernel_v2.cu semantics:
    per-sample numer = sum(2*sigmoid(x)*y), denor = sum(sigmoid(x)^p + y)
    over all non-batch axes, loss_i = 1 - (numer+smooth)/(denor+smooth).
    Returns [B] float32."""
    return _SoftDice.apply(logits, labels, p, smooth)
