"""Sigmoid focal loss (the CUDA-kernel variant) and its gradient in one
pass: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/focal.py (`_fused_kernel`). For
float32 logits x and targets y of one shape it returns (loss, grad),
both elementwise: loss = -|y - p|^gamma * ce and grad = d loss / d x
(focal.py:25-37). A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel (csrc/focal.cu) or raises.
Nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B


def focal_plain(x: torch.Tensor, y: torch.Tensor, gamma: float,
                alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """focal.py `_math`, op for op: the two-branch log sigmoid,
    coeff = -(|y - p|^gamma) and d_coeff negated where y < p."""
    prob = 1.0 / (1.0 + torch.exp(-x))
    log_p = torch.where(x >= 0, -torch.log1p(torch.exp(-x)),
                        x - torch.log1p(torch.exp(x)))
    ce = y * alpha * log_p + (1.0 - y) * (1.0 - alpha) * (log_p - x)
    a = (y - prob).abs()
    coeff = -(a ** gamma)
    loss = coeff * ce
    d_ce = y * alpha - prob * (1.0 - y - alpha + 2.0 * y * alpha)
    d_coeff = gamma * a ** (gamma - 1.0) * prob * (1.0 - prob)
    d_coeff = torch.where(y < prob, -d_coeff, d_coeff)
    return loss, d_coeff * ce + coeff * d_ce


def focal_fwd(x: torch.Tensor, y: torch.Tensor, gamma: float,
              alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, grad), float32 of x's shape. CUDA: csrc/focal.cu, one
    launch writing both; CPU: `focal_plain`."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return focal_plain(x, y, gamma, alpha)
    if x.shape != y.shape:
        raise ValueError(f"focal_fwd: need x and y of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"focal_fwd: need float32, got {x.dtype} / "
                        f"{y.dtype}")
    if not x.is_cuda or not y.is_cuda or x.device != y.device:
        raise ValueError(f"focal_fwd: tensors on {x.device} / {y.device}")
    if not x.is_contiguous() or not y.is_contiguous():
        raise ValueError("focal_fwd: tensors must be contiguous")
    loss = torch.empty_like(x)
    grad = torch.empty_like(x)
    if x.numel() == 0:
        return loss, grad
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_focal(x.data_ptr(), y.data_ptr(), loss.data_ptr(),
                               grad.data_ptr(), x.numel(), float(gamma),
                               float(alpha), B.aligned16(x, y, loss, grad),
                               B.stream_of(x))
    B.check(rc, "focal_fwd")
    B.LAUNCHES["focal"] += 1
    return loss, grad
