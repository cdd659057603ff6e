"""Per-channel (sum a, sum a*b) over a batch: BatchNorm's statistic and
gradient reductions (counterpart of cartseg_tpu/ops/pallas/
channel_sums.py).

One op serves both BatchNorm passes, as in JAX:
  forward stats:  channel_sums(x, x)  -> (sum x, sum x^2)
  backward sums:  channel_sums(dy, x) -> (sum dy, sum dy*x)

a, b: [N, C, H, W] of one shape (NCHW indexing; the memory may be
contiguous or `channels_last`), fp32 or bf16; the sums are fp32 [C].
CPU tensors take `channel_sums_plain`; CUDA tensors launch the
hand-written kernel (ops/cuda/channel_sums.py) or raise. The JAX lane
gate `supported()` has no counterpart: it fits the TPU's 128 lanes,
and the kernel takes every shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cartseg_tpu_torch.ops.cuda.channel_sums import channel_sums_cuda


def channel_sums_plain(a: torch.Tensor,
                       b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum a, sum a*b) over (0, 2, 3) in fp32: `channel_sums_xla`
    (channel_sums.py:101-106) in NCHW indexing."""
    af = a.to(torch.float32)
    return af.sum((0, 2, 3)), (af * b.to(torch.float32)).sum((0, 2, 3))


def channel_sums(a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum a, sum a*b) per channel, fp32 [C] each: the plain version on
    the CPU, the kernel on the card."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return channel_sums_plain(a, b)
    return channel_sums_cuda(a, b)
