"""ms of device time a step in the span `train.backward` inside
`Trainer.train_step` (backward layer: autograd through the loss and the
model), on the program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.backward")
