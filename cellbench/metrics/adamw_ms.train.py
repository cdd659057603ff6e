"""ms of the per-group AdamW update on a step's gradients:
`adamw_update` (optimizer layer) on the gradients of one forward and
backward of the step's batch, CUDA events after the window."""

import torch

from cellbench.timing import call_ms

REPS = 10


def read(ctx):
    if getattr(ctx, "kind", None) != "train":
        return None
    from cartseg_tpu_torch.data.augment import augment_batch
    from cartseg_tpu_torch.train.optim import adamw_update

    tr, state = ctx.trainer, ctx.state
    images, masks = ctx.pool[0]
    imgs, m = augment_batch(state.gen, images, masks, tr.aug_cfg)
    model = state.model.train()
    loss, _ = tr.loss_fn(tr._forward(model, imgs), m, ctx.sample_w)
    params = state.params
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    wd = tr.cfg.weight_decay
    return call_ms(lambda: adamw_update(params, grads, state.opt, ctx.gids,
                                        ctx.lrs, ctx.active, wd),
                   REPS, ctx.device)
