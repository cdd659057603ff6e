"""Label-smoothed softmax cross-entropy (counterpart of
cartseg_tpu/losses/label_smooth.py):

  * `smooth_one_hot`     - smoothed one-hot rows, all zero where ignored
  * `lsr_cross_entropy`  - the V1 math under autograd (the oracle)
  * `lsr_ce`             - unreduced LSR CE as a torch.autograd.Function
    whose forward and backward are the CUDA kernels on the card
    (ops/cuda/lsr.py; the JAX package's `lsr_ce_pallas`, the analog of
    the reference's lsr_cpp extension) and their plain versions on the
    CPU. The backward needs only the logits and labels.

Layout: channels-last, logits [..., C], labels [...] integer.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.lsr import lsr_bwd, lsr_fwd


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   lb_smooth: float = 0.1,
                   ignore_index: int = -100) -> torch.Tensor:
    """labels [...] -> [..., C] float32: lb_pos at the label, lb_neg
    elsewhere, all-zero rows where labels == ignore_index."""
    ignore = labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(labels), labels).long()
    lb_pos = 1.0 - lb_smooth
    lb_neg = lb_smooth / num_classes
    oh = torch.nn.functional.one_hot(safe, num_classes).to(torch.float32)
    oh = oh * (lb_pos - lb_neg) + lb_neg
    return torch.where(ignore.unsqueeze(-1), 0.0, oh)


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
