"""ms of device time a step in the span `train.forward` inside
`Trainer.train_step` (model layer: the autocast forward), on the
program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.forward")
