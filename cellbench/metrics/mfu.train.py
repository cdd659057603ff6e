"""% of the card's bf16 peak that the train step reaches: the reference
FLOPs of a step's forward and backward over the batch (counted on the
plain reference model, cellbench/counts.py) over the window's time a
step. None on a card the peaks table lacks."""

import torch

from cellbench.counts import peaks, unet_flops


def read(ctx):
    if getattr(ctx, "kind", None) != "train" \
            or ctx.device.type != "cuda" or not ctx.window["units"]:
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    flops = unet_flops(ctx.encoder, ctx.batch, ctx.size, backward=True)
    step_s = ctx.window["seconds"] / ctx.window["units"]
    return 100.0 * flops / (step_s * peak["bf16_flops_per_s"])
