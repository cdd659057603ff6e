"""ms of device time a step in the span `train.augment` inside
`Trainer.train_step` (augmentation layer: `augment_batch`), on the
program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.augment")
