"""ms of the on-card augmentation of the step's batch: `augment_batch`
with the trainer's pipeline (augmentation layer), from a copy of the
step's generator, CUDA events after the window."""

import torch

from cellbench.timing import call_ms

REPS = 10


def read(ctx):
    if getattr(ctx, "kind", None) != "train":
        return None
    from cartseg_tpu_torch.data.augment import augment_batch

    images, masks = ctx.pool[0]
    gen = torch.Generator(device=ctx.device)
    gen.set_state(ctx.state.gen.get_state())
    return call_ms(lambda: augment_batch(gen, images, masks,
                                         ctx.trainer.aug_cfg),
                   REPS, ctx.device)
