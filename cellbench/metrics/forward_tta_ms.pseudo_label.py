"""ms of the ensemble's forward with flip TTA on the cell's batch:
`ensemble_probs_fn(members, mean, std, tta_flip=True)` (model layer),
CUDA events over a few calls after the window."""

from cellbench.timing import call_ms

REPS = 3


def read(ctx):
    if getattr(ctx, "kind", None) != "pseudo_label":
        return None
    from cartseg_tpu_torch.infer.engine import ensemble_probs_fn

    fn = ensemble_probs_fn(ctx.members, ctx.mean, ctx.std, tta_flip=True)
    images = ctx.pool[0]
    return call_ms(lambda: fn(images), REPS, ctx.device)
