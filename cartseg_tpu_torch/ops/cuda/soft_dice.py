"""Per-sample soft-Dice sums: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/soft_dice.py (`_reduce_kernel`).
For float32 logits x and labels y [B, M] it returns fp32 [B] each of
numer = sum 2 p y and denor = sum (p^pexp + y), p = 1 / (1 + exp(-x)).
A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (csrc/soft_dice.cu) or raises. Nothing falls
back. One call is two launches (the partial sums, then their
fixed-order finish) and counts once in `LAUNCHES["soft_dice"]`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B

THREADS = 256
# partial sums per sample: enough blocks to fill the card, few enough
# that the finish launch is small
MAX_PARTIALS = 1024
# 4-element loads a thread takes at the least
MIN_STEPS = 4


def soft_dice_sums_plain(x: torch.Tensor, y: torch.Tensor,
                         pexp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numer, denor) [B] over every axis but the first (soft_dice.py
    `_reduce_kernel`: prob = 1 / (1 + exp(-x)))."""
    prob = 1.0 / (1.0 + torch.exp(-x))
    axes = tuple(range(1, x.dim()))
    return (2.0 * prob * y).sum(axes), (prob ** pexp + y).sum(axes)


def soft_dice_sums(x: torch.Tensor, y: torch.Tensor,
                   pexp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numer, denor) fp32 [B] for x, y [B, M]. CUDA: csrc/soft_dice.cu;
    CPU: `soft_dice_sums_plain`. The same inputs give the same bits on
    every call (fixed-order sums, no atomics)."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return soft_dice_sums_plain(x, y, pexp)
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"soft_dice_sums: need x, y [B,M] of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"soft_dice_sums: need float32, got {x.dtype} / "
                        f"{y.dtype}")
    if not x.is_cuda or not y.is_cuda or x.device != y.device:
        raise ValueError(f"soft_dice_sums: tensors on {x.device} / "
                         f"{y.device}")
    if not x.is_contiguous() or not y.is_contiguous():
        raise ValueError("soft_dice_sums: tensors must be contiguous")
    Bn, M = x.shape
    if Bn > 65535:
        raise ValueError(f"soft_dice_sums: B = {Bn} above 65535")
    if Bn == 0 or M == 0:
        return (torch.zeros(Bn, device=x.device),
                torch.zeros(Bn, device=x.device))
    out = torch.empty((2, Bn), dtype=torch.float32, device=x.device)
    P = max(1, min(MAX_PARTIALS, -(-M // (THREADS * 4 * MIN_STEPS))))
    vec = 4 if M % 4 == 0 and B.aligned16(x, y) else 1
    part = torch.empty((2, Bn, P), dtype=torch.float32, device=x.device)
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_soft_dice(x.data_ptr(), y.data_ptr(),
                                   part.data_ptr(), out.data_ptr(), Bn, M,
                                   P, vec, float(pexp), B.stream_of(x))
    B.check(rc, "soft_dice_sums")
    B.LAUNCHES["soft_dice"] += 1
    return out[0], out[1]
