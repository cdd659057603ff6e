"""Per-sample soft-Dice sums: the CUDA kernel's wrapper, its launch plan
and its plain PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/soft_dice.py (`_reduce_kernel`).
For float32 logits x and labels y [B, M] it returns fp32 [B] each of
numer = sum 2 p y and denor = sum (p^pexp + y), p = 1 / (1 + exp(-x)).
A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (csrc/soft_dice.cu) or raises. Nothing falls
back. One call is one CUDA kernel, counted once in
`LAUNCHES["soft_dice"]`: `plan`'s P CTAs a sample each store a partial
(numer, denor), and the last of a sample's CTAs to arrive folds its P
partials in a fixed order. The arrival counters are one row a stream of
a zeroed device buffer (`_counters`, ops/cuda/counters.py, its own and
not channel_sums'), made at the device's first call outside a CUDA-graph
capture and left zero by every call, so a call enqueues no memset.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B
from cartseg_tpu_torch.ops.cuda.counters import ArrivalCounters

THREADS = 256
# 16-byte loads of x (and of y) a thread issues a round, before it adds
# them (csrc kUnroll)
UNROLL = 1
# CTAs of 256 threads an SM holds at once (csrc kMinBlocks): a call fills
# one wave at most. One load a round in 6 CTAs an SM beat 2 and 4 loads
# in 4 or 8 on the card (PERF.md §6)
BLOCKS_PER_SM = 6
# the SMs of an H100 SXM, where the plan is not handed the card's count
SMS = 132
# samples a call takes (the grid's y extent), and so counters a stream
MAX_SAMPLES = 65535
COUNTER_SETS = 16

_ARRIVALS = ArrivalCounters("soft_dice", MAX_SAMPLES, COUNTER_SETS)
_counters = _ARRIVALS.row


class Plan(NamedTuple):
    vec: int    # elements a load: 4 (16 bytes) or 1
    P: int      # CTAs a sample, each storing one partial (numer, denor)
    L: int      # elements a CTA sums (a multiple of 4; the last fewer)


def plan(Bn: int, M: int, aligned: bool, sms: int = SMS) -> Plan:
    """The kernel's launch geometry for x, y [Bn, M] on a card of `sms`
    SMs: P CTAs a sample, enough that each thread issues UNROLL 16-byte
    loads of x (and of y), at most one wave (BLOCKS_PER_SM an SM) over
    the Bn samples and at least one CTA a sample; CTA q of a sample sums
    its elements [q L, (q + 1) L), L a multiple of 4. 16-byte loads when
    both pointers are aligned and M is a multiple of 4, else one element
    at a time (the same ranges)."""
    rounds = -(-M // (THREADS * 4 * UNROLL))
    P = max(1, min(sms * BLOCKS_PER_SM // Bn, rounds))
    L = -(-M // P)
    L = max(4, -(-L // 4) * 4)
    return Plan(4 if aligned and M % 4 == 0 else 1, -(-M // L), L)


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
    if Bn > MAX_SAMPLES:
        raise ValueError(f"soft_dice_sums: B = {Bn} above {MAX_SAMPLES}")
    if Bn == 0 or M == 0:
        return (torch.zeros(Bn, device=x.device),
                torch.zeros(Bn, device=x.device))
    p = plan(Bn, M, bool(B.aligned16(x, y)), B.sm_count(x.get_device()))
    return _launch(x, y, pexp, p)


def _launch(x: torch.Tensor, y: torch.Tensor, pexp: float,
            p: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on plan p (the tests force plans)."""
    Bn, M = x.shape
    out = torch.empty((2, Bn), dtype=torch.float32, device=x.device)
    part = torch.empty((Bn, p.P, 2), dtype=torch.float32, device=x.device)
    stream = B.stream_of(x)
    count = _counters(x.get_device(), stream)
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_soft_dice(x.data_ptr(), y.data_ptr(),
                                   part.data_ptr(), count, out.data_ptr(),
                                   Bn, M, p.P, p.L, p.vec, float(pexp),
                                   stream)
    B.check(rc, "soft_dice_sums")
    B.LAUNCHES["soft_dice"] += 1
    return out[0], out[1]
