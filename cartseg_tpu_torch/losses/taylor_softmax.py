"""Taylor softmax (taylor_softmax.cu:14-23, 46-95), counterpart of
cartseg_tpu/losses/taylor_softmax.py: softmax with exp replaced by the
order-n Taylor polynomial t(x) = sum_{i<=n} x^i / i!. Even n keeps
t(x) > 0 for all x. Channels-last."""

from __future__ import annotations

import torch

from cartseg_tpu_torch.losses.label_smooth import smooth_one_hot


def _taylor_series(x: torch.Tensor, n: int) -> torch.Tensor:
    res = 1.0 + x
    mid = x
    denor = 1.0
    for i in range(2, n + 1):
        denor = denor * i
        mid = mid * x
        res = res + mid / denor
    return res


def taylor_softmax(x: torch.Tensor, n: int = 2, axis: int = -1):
    t = _taylor_series(x.to(torch.float32), n)
    return t / t.sum(axis, keepdim=True)


def log_taylor_softmax(x: torch.Tensor, n: int = 2, axis: int = -1):
    t = _taylor_series(x.to(torch.float32), n)
    return torch.log(t) - torch.log(t.sum(axis, keepdim=True))


def taylor_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         n: int = 2, lb_smooth: float = 0.0,
                         ignore_index: int = -100, reduction: str = "mean"):
    """CE over taylor-softmax activations with optional label smoothing.
    The targets are `smooth_one_hot` rows (the one-hot kernel on the
    card); at lb_smooth = 0 they are the plain one-hot the JAX package
    builds in that case, bit for bit."""
    logs = log_taylor_softmax(logits, n=n, axis=-1)
    oh = smooth_one_hot(labels, logits.shape[-1], lb_smooth, ignore_index)
    ignore = labels == ignore_index
    loss = torch.where(ignore, 0.0, -(logs * oh).sum(-1))
    if reduction == "mean":
        return loss.sum() / (~ignore).sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss
