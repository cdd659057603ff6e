"""ms of device time a step in the span `train.optimizer` inside
`Trainer.train_step` (optimizer layer: the clip, the non-finite gate and
`adamw_update`), on the program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.optimizer")
