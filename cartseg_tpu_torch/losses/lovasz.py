"""Lovász losses (lovasz_softmax.cu:380-470, 799-801), counterpart of
cartseg_tpu/losses/lovasz.py: a descending sort of the errors per image
and class, and the cumulative-sum Jaccard gradient.

The sorts are stable (`torch.argsort(..., stable=True)`), as
jnp.argsort is: among tied errors the order decides which Jaccard delta
each gets, so an unstable sort changes the gradient. Autograd flows
through the gather by the sort permutation, the gradient the CUDA
backward computes by redistributing the Jaccard deltas.

Ignored pixels are handled masked-dense: their error is zeroed and
their fg bit cleared, which sorts them to the tail where a zero error
annihilates their Jaccard-delta contribution.
"""

from __future__ import annotations

import torch


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. the sorted errors, along
    the last axis."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + (1.0 - fg_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1],
                      jaccard[..., 1:] - jaccard[..., :-1]], -1)


def _sorted_dot(errors: torch.Tensor, fg: torch.Tensor,
                hinge: bool = False) -> torch.Tensor:
    """sum over the last axis of sorted(errors, descending) times the
    Lovász gradient of fg in that order (relu of the errors first for
    the hinge)."""
    order = torch.argsort(-errors, dim=-1, stable=True)
    errors_sorted = errors.gather(-1, order)
    if hinge:
        errors_sorted = torch.relu(errors_sorted)
    return (errors_sorted * _lovasz_grad(fg.gather(-1, order))).sum(-1)


def _lovasz_softmax_images(probs, labels, valid, classes: str):
    """probs [N,P,C], labels [N,P], valid [N,P] -> [N]: per image, the
    mean loss over the classes present in it (classes == "present") or
    over all classes."""
    C = probs.shape[-1]
    cls = torch.arange(C, device=probs.device)
    vf = valid.to(torch.float32).unsqueeze(1)                  # [N,1,P]
    fg = ((labels.unsqueeze(1) == cls[:, None]) & valid.unsqueeze(1)
          ).to(torch.float32)                                   # [N,C,P]
    errors = (fg - probs.transpose(1, 2)).abs() * vf
    losses = _sorted_dot(errors, fg)                            # [N,C]
    if classes == "present":
        w = (fg.sum(-1) > 0).to(torch.float32)
        return (losses * w).sum(-1) / w.sum(-1).clamp(min=1.0)
    return losses.mean(-1)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   classes: str = "present", per_image: bool = True,
                   ignore_index: int = -100):
    """logits [B,...,C] channels-last, labels [B,...] int.

    per_image=True matches the CUDA kernel (it always segments per
    image); per_image=False flattens the batch first.
    """
    logits = logits.to(torch.float32)
    B, C = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits, dim=-1).reshape(B, -1, C)
    labels = labels.reshape(B, -1)
    valid = labels != ignore_index
    if per_image:
        return _lovasz_softmax_images(probs, labels, valid, classes).mean()
    return _lovasz_softmax_images(probs.reshape(1, -1, C),
                                  labels.reshape(1, -1),
                                  valid.reshape(1, -1), classes)[0]


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 per_image: bool = True, ignore_index: int = -100):
    """Binary Lovász hinge. logits [B,...] (squeeze any channel dim of 1
    first), labels [B,...] in {0,1}."""
    logits = logits.to(torch.float32)
    B = logits.shape[0]
    lg = logits.reshape(B, -1)
    lb = labels.reshape(B, -1)
    vi = (lb != ignore_index).to(torch.float32)
    if not per_image:
        lg, lb, vi = lg.reshape(1, -1), lb.reshape(1, -1), vi.reshape(1, -1)
    fg = (lb > 0).to(torch.float32) * vi
    signs = 2.0 * fg - 1.0
    errors = (1.0 - lg * signs) * vi
    losses = _sorted_dot(errors, fg, hinge=True)
    return losses.mean() if per_image else losses[0]
