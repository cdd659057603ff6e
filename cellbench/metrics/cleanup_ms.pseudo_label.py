"""ms of the CC cleanup on the cell's batch:
`remove_small_components(probs >= t, min_area)` (CC cleanup layer),
CUDA events after the window."""

import torch

from cellbench.timing import call_ms

REPS = 20


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label":
        return None
    from cartseg_tpu_torch.ops.connected_components import (
        remove_small_components)

    with torch.inference_mode():
        _, probs, _ = ctx.program(ctx.pool[0], ctx.threshold)
        mask = probs >= ctx.threshold
        return call_ms(lambda: remove_small_components(mask, ctx.min_area),
                       REPS, ctx.device)
