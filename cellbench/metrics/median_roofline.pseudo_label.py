"""% of its roofline that `median_nonneg_last_axis` reaches on the QC's
confidence rows |p - 0.5| * 2 of the batch ([B, H*W] float32): the bound
(the rows read once, [B] written once, at the card's HBM rate) over the
call's time (CUDA events, back to back, after the window). None on a
card the peaks table lacks."""

import torch

from cellbench.counts import median_bytes, peaks
from cellbench.timing import call_ms

REPS = 50


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label" \
            or ctx.device.type != "cuda":
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    from cartseg_tpu_torch.ops.cuda.median import median_nonneg_last_axis

    with torch.inference_mode():
        _, probs, _ = ctx.program(ctx.pool[0], ctx.threshold)
        conf = ((probs - 0.5).abs() * 2.0).reshape(probs.shape[0], -1)
        conf = conf.contiguous()
        ms = call_ms(lambda: median_nonneg_last_axis(conf), REPS, ctx.device)
    bound_ms = median_bytes(*conf.shape) / peak["hbm_bytes_per_s"] * 1e3
    return 100.0 * bound_ms / ms
