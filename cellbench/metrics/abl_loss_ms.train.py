"""ms of the ABL trainer's loss, forward and backward, on the step's
logits and masks (ABL loss layer: BCE+Dice, the EDT, the neighbour KL,
`lsr_ce`), CUDA events after the window. None where the trainer's loss
is not bce_dice_abl."""

import torch

from cellbench.timing import call_ms

REPS = 10


def read(ctx):
    if getattr(ctx, "kind", None) != "train" \
            or ctx.cell.traffic["loss"]["name"] != "bce_dice_abl":
        return None
    from cartseg_tpu_torch.data.augment import augment_batch

    tr, state = ctx.trainer, ctx.state
    images, masks = ctx.pool[0]
    imgs, m = augment_batch(state.gen, images, masks, tr.aug_cfg)
    with torch.no_grad():
        logits = tr._forward(state.model.train(), imgs)
    logits.requires_grad_(True)

    def call():
        loss, _ = tr.loss_fn(logits, m, ctx.sample_w)
        torch.autograd.grad(loss, [logits])

    return call_ms(call, REPS, ctx.device)
