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

One call is one CUDA kernel, counted once in `LAUNCHES["channel_sums"]`:
its CTAs write partial rows, and the last CTA of each column (NHWC) or
channel (NCHW) to arrive sums them in a fixed order. The arrival
counters are one row a stream of a zeroed device buffer (`_counters`,
ops/cuda/counters.py, its own and not soft_dice's), made at the device's
first call and reset to zero by each call's last CTA, so a call enqueues
no memset. A call captured into a CUDA graph takes the capturing
stream's counters, which need one call on the card before the capture
(on any stream) to have made the device's buffer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from cartseg_tpu_torch.ops.cuda import build as B
from cartseg_tpu_torch.ops.cuda.counters import ArrivalCounters

THREADS = 256
# independent loads a thread issues before it adds them (csrc kUnroll)
UNROLL = 4
# loads a thread takes before the plan adds CTAs
MIN_LOADS = 2 * UNROLL
# CTAs of 256 threads an SM holds at once: a call fills one wave at most
BLOCKS_PER_SM = 4
# the SMs of an H100 SXM, where the plan is not handed the card's count
SMS = 132
# partial floats (both sums) the finishing CTA of an NHWC column reads
# before the plan cuts the column narrower ...
FINISH_FLOATS = 8192
# ... down to one 16-byte load of each row a column
MIN_COLUMN_BYTES = 16
# columns (NHWC) or channels (NCHW) a stream's counter set holds, and the
# stream sets a device's buffer holds
MAX_COUNTERS = 65536
COUNTER_SETS = 16
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    nhwc: bool     # rows [N*H*W, C] (channels_last), else [N, C, H*W]
    vec: int       # elements a thread loads at once
    P: int         # CTAs a column (NHWC) or channel (NCHW): partial rows
    tc: int        # NHWC: channel-group lanes of a block (a power of two)
    gy: int        # NHWC: columns of tc * vec channels; NCHW: C

    @property
    def rows(self) -> int:
        """NHWC: row lanes of a block."""
        return THREADS // self.tc

    @property
    def width(self) -> int:
        """NHWC: channels a column holds (tc * vec)."""
        return self.tc * self.vec

    def part_floats(self) -> int:
        """fp32 scratch the kernel's partial rows take."""
        if self.nhwc:
            return self.gy * self.P * 2 * self.width
        return self.gy * self.P * 2


def memory_order(t: torch.Tensor) -> str:
    """'nchw' (contiguous), 'nhwc' (channels_last) or 'strided'. A tensor
    dense in both orders (C == 1, or H == W == 1) counts as NCHW."""
    if t.is_contiguous():
        return "nchw"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "strided"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(shape, nhwc: bool, dtypes, ptrs, sms: int = SMS) -> Plan:
    """The kernel's launch geometry for [N, C, H, W] inputs of the given
    types and data pointers on a card of `sms` SMs.

    Loads: 16 bytes (8 bf16 or 4 fp32, 4 when the types differ) where the
    contiguous extent (C in NHWC, H*W in NCHW) divides into them and both
    pointers are aligned, else one element at a time.
    CTAs: enough that each thread takes MIN_LOADS loads, at most one wave
    (BLOCKS_PER_SM a SM). So layer4's 1.5 MB at 512^2 bs6 takes a few
    dozen CTAs and the stem and decoder top fill the card.
    NHWC columns: tc, the next power of two of the channel groups, halved
    while the finishing CTA would read more than FINISH_FLOATS partials
    and a row's share of the column stays MIN_COLUMN_BYTES or more."""
    return _plan(shape, nhwc, dtypes, ptrs, sms, MIN_LOADS, FINISH_FLOATS)


def _plan(shape, nhwc: bool, dtypes, ptrs, sms: int, min_loads: int,
          finish_floats: int) -> Plan:
    """`plan` at other sizing constants (the tests force small CTAs and
    narrow columns with it)."""
    (da, db), (pa, pb) = dtypes, ptrs
    wide = 8 if da == db == torch.bfloat16 else 4
    aligned = (pa % (wide * da.itemsize) == 0
               and pb % (wide * db.itemsize) == 0)
    return _sized(tuple(shape), nhwc, (da, db), aligned, sms, min_loads,
                  finish_floats)


@functools.lru_cache(maxsize=4096)
def _sized(shape, nhwc: bool, dtypes, aligned: bool, sms: int,
           min_loads: int, finish_floats: int) -> Plan:
    """The plan by shape, types and alignment (a step's BN layers repeat a
    few shapes, so each call finds its plan made)."""
    N, C, H, W = shape
    wide = 8 if all(d == torch.bfloat16 for d in dtypes) else 4
    extent = C if nhwc else H * W
    vec = wide if extent % wide == 0 and aligned else 1
    loads = N * C * H * W // vec
    ctas = max(1, min(sms * BLOCKS_PER_SM,
                      -(-loads // (THREADS * min_loads))))
    if not nhwc:
        per_channel = -(-N * H * W // (THREADS * vec))
        return Plan(False, vec, max(1, min(ctas // C, per_channel)), 1, C)
    groups, M = C // vec, N * H * W
    itemsize = min(d.itemsize for d in dtypes)

    def columns(tc):
        gy = -(-groups // tc)
        P = max(1, min(ctas // gy, -(-M // (THREADS // tc))))
        return gy, P

    tc = min(_pow2_at_least(groups), THREADS)
    while (tc > 1 and columns(tc)[1] * 2 * tc * vec > finish_floats
           and tc // 2 * vec * itemsize >= MIN_COLUMN_BYTES):
        tc //= 2
    gy, P = columns(tc)
    return Plan(True, vec, P, tc, gy)


# the arrival counters, one row of MAX_COUNTERS a stream
_ARRIVALS = ArrivalCounters("channel_sums", MAX_COUNTERS, COUNTER_SETS)
# device index -> int32 [COUNTER_SETS, MAX_COUNTERS] zeros
_COUNTERS = _ARRIVALS.buffers
_counters = _ARRIVALS.row


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
    if a.numel() == 0:
        return torch.zeros((2, a.shape[1]), dtype=torch.float32,
                           device=a.device).unbind(0)
    p = plan(a.shape, order == "nhwc", (a.dtype, b.dtype),
             (a.data_ptr(), b.data_ptr()), B.sm_count(a.get_device()))
    return _launch(a, b, p)


def _launch(a: torch.Tensor, b: torch.Tensor,
            p: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on plan p (the tests and tools force plans)."""
    N, C, H, W = a.shape
    same = b is a or (b.data_ptr() == a.data_ptr() and b.dtype == a.dtype
                      and b.stride() == a.stride())
    out = torch.empty((2, C), dtype=torch.float32, device=a.device)
    part = torch.empty((p.part_floats(),), dtype=torch.float32,
                       device=a.device)
    stream = B.stream_of(a)
    count = _counters(a.get_device(), stream)
    lib = B.load_library()
    with torch.cuda.device(a.device):
        rc = lib.cartseg_channel_sums(
            a.data_ptr(), b.data_ptr(), part.data_ptr(), count,
            out.data_ptr(), _BF16[a.dtype], _BF16[b.dtype], int(same),
            int(p.nhwc), N, C, H * W, p.vec, p.P, p.tc, stream)
    B.check(rc, "channel_sums")
    B.LAUNCHES["channel_sums"] += 1
    return out[0], out[1]
