"""ms of device time a step in the span `train.loss` inside
`Trainer.train_step` (loss layer: the loss's forward, with ABL's EDT
and LSR forward where the loss has them), on the program's CUDA events
(cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.loss")
