"""% of the card's bf16 peak that the pseudo-label program reaches: the
reference FLOPs of a batch (every member's forward over the frames and
their mirrors, counted on the plain reference model, cellbench/counts.py)
over the window's time a batch. None on a card the peaks table lacks."""

import torch

from cellbench.counts import peaks, unet_flops


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label" \
            or ctx.device.type != "cuda" or not ctx.window["units"]:
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    flops = len(ctx.params) * unet_flops(ctx.encoder, 2 * ctx.batch,
                                         ctx.size, backward=False)
    batch_s = ctx.window["seconds"] / ctx.window["units"]
    return 100.0 * flops / (batch_s * peak["bf16_flops_per_s"])
