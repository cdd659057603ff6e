"""% of their roofline that the flash attention kernels reach in the SAM
fine-tune step: the attention's own arithmetic of the step's global
blocks (cellbench/counts_sam.py `attention_flops`: 4 bnh S^2 d a
forward, 8 a backward, no recomputation credited) at the card's bf16
peak, over the device time of the forward, dq and dkv kernels
(`flash_fwd_*`, `flash_bwd_dq_*`, `flash_bwd_dkv_*`) in PROFILE_UNITS
steps of the driver's profiled unit under the port's `device_kernels`
(torch.profiler), after the window. A window that lost a launch of
them is taken again. None off a card, outside a SAM cell, on a card the
peaks table lacks, or where every window lost one."""

import time

import torch

from cellbench.counts import peaks
from cellbench.counts_sam import attention_flops
from cellbench.harness import PROFILE_UNITS
from cellbench.timing import PROFILE_PAUSE_S, PROFILE_TRIES

KERNELS = ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_")


def flash_us(kernels: dict, launches: int):
    """The summed device us of the three flash kernels from
    `device_kernels`' {name: (launches, us)}, where each ran `launches`
    times; None where one did not."""
    got = [[0, 0.0] for _ in KERNELS]
    for name, (n, us) in kernels.items():
        for i, k in enumerate(KERNELS):
            if k in name:
                got[i][0] += n
                got[i][1] += us
    if any(n != launches for n, _ in got):
        return None
    return sum(us for _, us in got)


def read(ctx):
    if getattr(ctx, "kind", None) != "train" or not hasattr(ctx, "sizes") \
            or ctx.device.type != "cuda":
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    from cartseg_tpu_torch.utils.profiling import device_kernels

    unit, _ = ctx.cell.driver.profiled_unit(ctx)
    launches = len(ctx.sizes.global_attn_indexes) * PROFILE_UNITS
    for i in range(PROFILE_TRIES):
        time.sleep(PROFILE_PAUSE_S * i)
        us = flash_us(device_kernels(unit, PROFILE_UNITS), launches)
        if us is not None:
            work = attention_flops(ctx.sizes, ctx.batch) * PROFILE_UNITS
            return 100.0 * work / (us * 1e-6 * peak["bf16_flops_per_s"])
    return None
