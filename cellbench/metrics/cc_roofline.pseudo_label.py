"""% of its roofline that `ops/cuda/cc.py` `cc_batch` reaches on the
batch's thresholded mask: the bound (bool [B,H,W] read once, int32
labels written once, at the card's HBM rate) over the call's time
(CUDA events, back to back, after the window). None on a card the
peaks table lacks."""

import torch

from cellbench.counts import cc_bytes, peaks
from cellbench.timing import call_ms

REPS = 50


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label" \
            or ctx.device.type != "cuda":
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    from cartseg_tpu_torch.ops.cuda.cc import cc_batch

    with torch.inference_mode():
        _, probs, _ = ctx.program(ctx.pool[0], ctx.threshold)
        mask = (probs >= ctx.threshold).contiguous()
        ms = call_ms(lambda: cc_batch(mask), REPS, ctx.device)
    bound_ms = cc_bytes(*mask.shape) / peak["hbm_bytes_per_s"] * 1e3
    return 100.0 * bound_ms / ms
