"""Online hard example mining relabeling (ohem_label_kernel.cu:120-174),
counterpart of cartseg_tpu/losses/ohem.py: the softmax probability of
each position's true class, the n_min hardest (lowest-score) positions
kept unconditionally, and every other position whose score exceeds
score_thresh set to ignore_index.

One stable sort of the flattened scores ranks the positions; jnp.argsort
is stable too, so tied scores keep their order and both frameworks drop
the same positions.
"""

from __future__ import annotations

import torch


def ohem_labels(logits: torch.Tensor, labels: torch.Tensor,
                score_thresh: float = 0.7, n_min: int = 16,
                ignore_index: int = 255) -> torch.Tensor:
    """logits [..., C] channels-last, labels [...] int. Returns the
    relabeled int labels, of labels' shape and type."""
    flat_labels = labels.reshape(-1)
    if n_min >= flat_labels.shape[0]:
        return labels
    flat_logits = logits.to(torch.float32).reshape(-1, logits.shape[-1])
    ignore = flat_labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(flat_labels), flat_labels)
    probs = torch.softmax(flat_logits, dim=-1)
    scores = probs.gather(-1, safe.long().unsqueeze(-1))[:, 0]
    # ignored positions score 1.0 so they sort last (kernel :131-132)
    scores = torch.where(ignore, 1.0, scores)
    order = torch.argsort(scores, stable=True)    # ascending: hardest first
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    drop = (rank >= n_min) & (scores > score_thresh)
    out = torch.where(drop, torch.full_like(flat_labels, ignore_index),
                      flat_labels)
    return out.reshape(labels.shape)
