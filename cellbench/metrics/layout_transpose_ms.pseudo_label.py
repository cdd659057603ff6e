"""ms of device time a batch in cuDNN's layout transposes
(`nchwToNhwcKernel`, `nhwcToNchwKernel`), which cuDNN wraps around a
convolution whose tensors are not in the layout of its kernel: the
cell's profiled unit (`profiled_unit`) PROFILE_UNITS times under the
port's `device_kernels` (torch.profiler), after the window. 0.0 where
kernels came back and none is a transpose; None off a card, or where
every profiler window came back without a kernel."""

import time

from cellbench.harness import PROFILE_UNITS
from cellbench.timing import PROFILE_PAUSE_S, PROFILE_TRIES

TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


def transpose_ms(kernels: dict, units: int):
    """The ms a unit of every kernel whose name holds a transpose's, from
    `device_kernels`' {name: (launches, us)}; None where it is empty."""
    if not kernels:
        return None
    us = sum(t for name, (_, t) in kernels.items()
             if any(k in name for k in TRANSPOSES))
    return us * 1e-3 / units


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label" \
            or ctx.device.type != "cuda":
        return None
    from cartseg_tpu_torch.utils.profiling import device_kernels

    unit, _ = ctx.cell.driver.profiled_unit(ctx)
    # torch.profiler can drop a whole window's kernels on the card
    for i in range(PROFILE_TRIES):
        time.sleep(PROFILE_PAUSE_S * i)
        got = transpose_ms(device_kernels(unit, PROFILE_UNITS),
                           PROFILE_UNITS)
        if got is not None:
            return got
    return None
