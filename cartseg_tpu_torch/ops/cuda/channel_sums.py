"""Per-channel (sum a, sum a*b) on the card: the CUDA kernel's wrapper
and its launch plan.

The kernel (csrc/channel_sums.cu) replaces `_sums_kernel`
(cartseg_tpu/ops/pallas/channel_sums.py:39). For a, b [N, C, H, W] of
the same shape, fp32 or bf16, it returns (sum a, sum a*b) over N, H and
W as two fp32 [C] tensors, reading either memory order as it lies:
contiguous (NCHW) or `channels_last` (NHWC), both inputs in one. The
wrapper takes CUDA tensors only and raises on anything else; the op
that dispatches by device, and the plain version, are
ops/channel_sums.py.

One call is two launches (the partial sums, then their fixed-order
finish) and counts once in `LAUNCHES["channel_sums"]`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B

THREADS = 256
# partial rows per channel: enough blocks to fill the card, few enough
# that the finish launch is small
MAX_PARTIALS = 1024
# row (NHWC) or vector (NCHW) steps a thread takes at the least
MIN_STEPS = 4
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    nhwc: bool     # rows [N*H*W, C] (channels_last), else [N, C, H*W]
    vec: int       # elements a thread loads at once
    P: int         # partial sums per channel
    tc: int        # NHWC: channel-group lanes of a block
    R: int         # NHWC: row lanes of a block


def memory_order(t: torch.Tensor) -> str:
    """'nchw' (contiguous), 'nhwc' (channels_last) or 'strided'. A tensor
    dense in both orders (C == 1, or H == W == 1) counts as NCHW."""
    if t.is_contiguous():
        return "nchw"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "strided"


def plan(shape, nhwc: bool, dtypes, ptrs) -> Plan:
    """The kernel's launch geometry for [N, C, H, W] inputs of the given
    types and data pointers: 16-byte loads (8 bf16 or 4 fp32, 4 when the
    types differ) where the contiguous extent (C in NHWC, H*W in NCHW)
    divides into them and both pointers are aligned, else one element
    at a time."""
    N, C, H, W = shape
    wide = 8 if all(d == torch.bfloat16 for d in dtypes) else 4
    extent = C if nhwc else H * W
    aligned = all(p % (wide * d.itemsize) == 0 for p, d in zip(ptrs, dtypes))
    vec = wide if extent % wide == 0 and aligned else 1
    if nhwc:
        groups = C // vec
        tc = min(groups, THREADS)
        R = THREADS // tc
        steps = -(-N * H * W // (R * MIN_STEPS))
    else:
        tc = R = 1
        steps = -(-N * H * W // (THREADS * vec * MIN_STEPS))
    return Plan(nhwc, vec, max(1, min(MAX_PARTIALS, steps)), tc, R)


def _check(a: torch.Tensor, b: torch.Tensor) -> str:
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"channel_sums: need a, b [N,C,H,W] of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    for t in (a, b):
        if t.dtype not in _BF16:
            raise TypeError(f"channel_sums: need float32 or bfloat16, got "
                            f"{t.dtype}")
    if not a.is_cuda or not b.is_cuda or a.device != b.device:
        raise ValueError(f"channel_sums: tensors on {a.device} / {b.device}")
    order = memory_order(a)
    if order == "strided" or memory_order(b) != order:
        raise ValueError(
            f"channel_sums: a and b must both be contiguous or both "
            f"channels_last, got strides {a.stride()} and {b.stride()}")
    if a.shape[1] > 65535:
        raise ValueError(f"channel_sums: C = {a.shape[1]} above 65535")
    return order


def channel_sums_cuda(a: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum a, sum a*b) per channel, fp32 [C] each, by the kernel. With b
    the same tensor as a (BatchNorm's forward), the kernel reads a
    once."""
    order = _check(a, b)
    N, C, H, W = a.shape
    out = torch.empty((2, C), dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return out.zero_().unbind(0)
    same = b is a or (b.data_ptr() == a.data_ptr() and b.dtype == a.dtype
                      and b.stride() == a.stride())
    p = plan(a.shape, order == "nhwc", (a.dtype, b.dtype),
             (a.data_ptr(), b.data_ptr()))
    part = torch.empty((2, p.P, C), dtype=torch.float32, device=a.device)
    lib = B.load_library()
    with torch.cuda.device(a.device):
        rc = lib.cartseg_channel_sums(
            a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(),
            _BF16[a.dtype], _BF16[b.dtype], int(same), int(p.nhwc), N, C,
            H * W, p.vec, p.P, p.tc, p.R, B.stream_of(a))
    B.check(rc, "channel_sums")
    B.LAUNCHES["channel_sums"] += 1
    return out[0], out[1]
