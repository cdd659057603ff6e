"""ms of host time a step in the span `train.step` (train step layer):
the time the host takes to enqueue a step, or longer where the step
waits on the card inside (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "train.step", "host_ms")
