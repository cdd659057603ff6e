"""% of the card's bf16 peak that the SAM fine-tune step reaches: the
reference FLOPs of a step's forward and backward over the batch
(cellbench/counts_sam.py, FlopCounterMode over the plain reference on
the meta device) over the window's time a step. None off a card, outside
a SAM cell, and on a card the peaks table lacks."""

import torch

from cellbench.counts import peaks
from cellbench.counts_sam import step_flops


def read(ctx):
    if getattr(ctx, "kind", None) != "train" or not hasattr(ctx, "sizes") \
            or ctx.device.type != "cuda" or not ctx.window["units"]:
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    step_s = ctx.window["seconds"] / ctx.window["units"]
    return 100.0 * step_flops(ctx.sizes, ctx.batch) / (
        step_s * peak["bf16_flops_per_s"])
