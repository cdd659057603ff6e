"""Large-margin softmax CE (large_margin_kernel.cu:259-315), counterpart
of cartseg_tpu/losses/large_margin.py:

  loss = CE(logits, y)
       + (lam/2) * sum_{j != y} (q_j - 1/(C-1)) * log(q_j)

where q = softmax over the non-target classes only, by a log-softmax
with the target masked to -1e30.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def large_margin_softmax(logits: torch.Tensor, labels: torch.Tensor,
                         lam: float = 0.3, ignore_index: int = -100,
                         reduction: str = "mean"):
    """logits [..., C] channels-last, labels [...] int."""
    logits = logits.to(torch.float32)
    C = logits.shape[-1]
    ignore = labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(labels), labels).long()
    oh = safe.unsqueeze(-1) == torch.arange(C, device=logits.device)

    # standard CE over all classes
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, safe.unsqueeze(-1))[..., 0]

    # q = softmax over non-target classes (target masked to -1e30)
    logq = torch.log_softmax(torch.where(oh, _NEG, logits), dim=-1)
    term = torch.where(oh, 0.0, (torch.exp(logq) - 1.0 / (C - 1)) * logq)
    margin = (lam / 2.0) * term.sum(-1)

    loss = torch.where(ignore, 0.0, ce + margin)
    if reduction == "mean":
        return loss.sum() / (~ignore).sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss
