"""Arrival counters of the kernels that finish a fixed-order reduction in
the launch that wrote its partials (csrc/arrival.cuh): `channel_sums` and
`soft_dice`.

Each kernel's CTAs count themselves in on one counter a group (a channel,
a column, a sample), and the last CTA to arrive wraps it back to zero.
So a kernel needs zeroed counters once, not a memset a call, and two
calls in flight at once must not share them: each kernel owns one
`ArrivalCounters`, which holds one zeroed int32 buffer a device, made at
the device's first call outside a CUDA-graph capture, and hands each
stream a row of it. A call captured into a CUDA graph takes the
capturing stream's row, so the kernel needs one call on the card before
the capture (on any stream) to have made the device's buffer.
"""

from __future__ import annotations

import torch


class ArrivalCounters:
    """Rows of `width` counters, one a stream, at most `sets` streams a
    device, for the kernel named `owner` (in the errors)."""

    def __init__(self, owner: str, width: int, sets: int):
        self.owner, self.width, self.sets = owner, width, sets
        # device index -> int32 [sets, width] zeros
        self.buffers: dict = {}
        # (device index, stream) -> the address of the stream's row
        self.rows: dict = {}

    def row(self, index: int, stream: int) -> int:
        """The address of the stream's counters on device `index`. The
        kernel leaves them zero, so they are zeroed only once."""
        row = self.rows.get((index, stream))
        if row is not None:
            return row
        if index not in self.buffers:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.owner}: the first call on a device must run "
                    "outside a CUDA-graph capture (it makes the arrival "
                    "counters)")
            self.buffers[index] = torch.zeros(
                (self.sets, self.width), dtype=torch.int32,
                device=torch.device("cuda", index))
        used = sum(1 for i, _ in self.rows if i == index)
        if used == self.sets:
            raise RuntimeError(f"{self.owner}: more than {self.sets} streams "
                               f"on cuda:{index}")
        row = self.buffers[index][used].data_ptr()
        self.rows[(index, stream)] = row
        return row
