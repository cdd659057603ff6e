"""Sigmoid focal loss (the CUDA-kernel variant) and its gradient in one
pass: the CUDA kernel's wrapper, its launch plan and its plain PyTorch
version.

Counterpart of cartseg_tpu/ops/pallas/focal.py (`_fused_kernel`). For
float32 logits x and targets y of one shape it returns (loss, grad),
both elementwise: loss = -|y - p|^gamma * ce and grad = d loss / d x
(focal.py:25-37). A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel (csrc/focal.cu) or raises.
Nothing falls back. One call is one CUDA kernel, counted once in
`LAUNCHES["focal"]`: one exp an element, the exponent's route picked by
`route` (gamma 2 and 1 by multiplies, any other by powf), the grid by
`plan` (at most one wave, equal ranges).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B

THREADS = 256
# 16-byte loads of x (and of y) a thread issues a round, before its math
# (csrc kUnroll)
UNROLL = 2
# CTAs of 256 threads an SM holds at once (csrc kMinBlocks): a call fills
# one wave at most. 2 loads a round in 4 CTAs an SM beat 1, 4 and 8 loads
# and 5 or 8 CTAs (8 caps registers at 32 and spills) on the card (PERF.md
# §6)
BLOCKS_PER_SM = 4
# the SMs of an H100 SXM, where the plan is not handed the card's count
SMS = 132


class Plan(NamedTuple):
    vec: int    # 4: 16-byte loads and stores; 1: one element at a time
    ctas: int   # CTAs in the grid
    L: int      # elements a CTA takes (a multiple of 4; the last fewer)


def plan(n: int, aligned: bool, sms: int = SMS) -> Plan:
    """The kernel's launch geometry for n elements on a card of `sms`
    SMs: enough CTAs that each thread issues UNROLL 16-byte loads of x
    (and of y), at most one wave (BLOCKS_PER_SM an SM); CTA b takes
    elements [b L, (b + 1) L), L a multiple of 4, so every CTA has the
    same work but the last. 16-byte loads when every pointer is aligned,
    else one element at a time (the same ranges)."""
    rounds = -(-n // (THREADS * 4 * UNROLL))
    ctas = max(1, min(sms * BLOCKS_PER_SM, rounds))
    L = -(-n // ctas)
    L = max(4, -(-L // 4) * 4)
    return Plan(4 if aligned else 1, -(-n // L), L)


def route(gamma: float) -> int:
    """The kernel's exponent route: 2 (a^g = a a, a^(g-1) = a) for
    gamma = 2, 1 (a and 1) for gamma = 1, 0 (powf) for any other."""
    return {2.0: 2, 1.0: 1}.get(float(gamma), 0)


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
    p = plan(x.numel(), bool(B.aligned16(x, y, loss, grad)),
             B.sm_count(x.get_device()))
    return _launch(x, y, gamma, alpha, p, loss, grad)


def _launch(x: torch.Tensor, y: torch.Tensor, gamma: float, alpha: float,
            p: Plan, loss: torch.Tensor,
            grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on plan p into loss and grad (the tests force
    plans)."""
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_focal(x.data_ptr(), y.data_ptr(), loss.data_ptr(),
                               grad.data_ptr(), x.numel(), p.L, p.ctas,
                               float(gamma), float(alpha), p.vec,
                               route(gamma), B.stream_of(x))
    B.check(rc, "focal_fwd")
    B.LAUNCHES["focal"] += 1
    return loss, grad
