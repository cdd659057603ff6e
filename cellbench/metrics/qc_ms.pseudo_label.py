"""ms of the QC statistics on the cell's batch:
`qc_stats_fn()(probs, probs_flip, images, t)` with the Canny gate (QC
layer: the Canny front end, the reach kernel, the median kernel), under
the program's float32 policy, CUDA events after the window."""

import torch

from cellbench.timing import call_ms

REPS = 20


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label":
        return None
    from cartseg_tpu_torch.device import fp32_policy
    from cartseg_tpu_torch.infer.engine import (ensemble_probs_fn,
                                                qc_stats_fn)

    t = ctx.cell.traffic
    images = ctx.pool[0]
    probs, probs_flip = ensemble_probs_fn(ctx.members, ctx.mean, ctx.std,
                                          tta_flip=True)(images)
    qc = qc_stats_fn(edge_method="canny", canny_low=t["canny_low"],
                     canny_high=t["canny_high"])
    with torch.inference_mode(), fp32_policy():
        return call_ms(lambda: qc(probs, probs_flip, images, ctx.threshold),
                       REPS, ctx.device)
