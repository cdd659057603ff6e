"""Label-smoothed softmax cross-entropy (counterpart of
cartseg_tpu/losses/label_smooth.py):

  * `smooth_one_hot`     - smoothed one-hot rows, all zero where ignored:
    the CUDA kernel of the JAX package's `smooth_one_hot_pallas` on the
    card (ops/cuda/one_hot.py), its plain version on the CPU
  * `lsr_cross_entropy`  - the V1 math under autograd (the oracle)
  * `lsr_ce`             - unreduced LSR CE as a torch.autograd.Function
    whose forward and backward are the CUDA kernels on the card
    (ops/cuda/lsr.py; the JAX package's `lsr_ce_pallas`, the analog of
    the reference's lsr_cpp extension) and their plain versions on the
    CPU. The backward needs only the logits and labels.
  * `lsr_cross_entropy_fused` - the JAX package's name for the same
    function: unreduced, with the V2 hand-derived backward
    (label_smooth.py:61-90 there), which is what `lsr_ce` computes.

Layout: channels-last, logits [..., C], labels [...] integer.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.lsr import lsr_bwd, lsr_fwd
from cartseg_tpu_torch.ops.cuda.one_hot import one_hot


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   lb_smooth: float = 0.1,
                   ignore_index: int = -100) -> torch.Tensor:
    """labels [...] -> [..., C] float32: lb_pos = 1 - lb_smooth at the
    label, lb_neg = lb_smooth / C elsewhere, all-zero rows where labels
    == ignore_index. The values are those `smooth_one_hot_pallas` writes;
    the JAX XLA lane's `oh * (lb_pos - lb_neg) + lb_neg` can round
    lb_pos one float32 ulp away from them."""
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.long()
    return one_hot(labels.contiguous(), num_classes, lb_smooth,
                   ignore_index)


def lsr_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                      lb_smooth: float = 0.1, reduction: str = "mean",
                      ignore_index: int = -100) -> torch.Tensor:
    """V1 math; 'mean' divides by the count of non-ignored positions."""
    logits = logits.to(torch.float32)
    ignore = labels == ignore_index
    oh = smooth_one_hot(labels, logits.shape[-1], lb_smooth, ignore_index)
    loss = -(torch.log_softmax(logits, dim=-1) * oh).sum(-1)
    loss = torch.where(ignore, 0.0, loss)
    if reduction == "mean":
        return loss.sum() / (~ignore).sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss


class _LSRCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, lb_smooth, ignore_index):
        C = logits.shape[-1]
        x = logits.to(torch.float32).reshape(-1, C).contiguous()
        lab = labels.reshape(-1)
        ctx.save_for_backward(x, lab)
        ctx.lb_smooth, ctx.ignore_index = lb_smooth, ignore_index
        ctx.shape, ctx.dtype = logits.shape, logits.dtype
        return lsr_fwd(x, lab, lb_smooth, ignore_index).reshape(
            labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        grad = lsr_bwd(x, lab, g.reshape(-1), ctx.lb_smooth,
                       ctx.ignore_index)
        return grad.reshape(ctx.shape).to(ctx.dtype), None, None, None


def lsr_ce(logits: torch.Tensor, labels: torch.Tensor,
           lb_smooth: float = 0.1, ignore_index: int = -100) -> torch.Tensor:
    """Per-position LSR CE [...] (unreduced); logits [..., C]."""
    return _LSRCrossEntropy.apply(logits, labels, lb_smooth, ignore_index)


# the JAX package's name (cartseg_tpu/losses/label_smooth.py:61): the same
# function and hand-derived backward as `lsr_ce`
lsr_cross_entropy_fused = lsr_ce
