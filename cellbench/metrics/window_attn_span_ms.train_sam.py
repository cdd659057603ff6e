"""ms of device time a step in the spans `sam.window_attn` (windowed
attention layer: each windowed block's attention in the forward, with
its window partition and unpartition, its projections and its fp32
softmax), summed over the step's eight blocks, on the program's CUDA
events (cellbench/spans.py). None where the program has no such span."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "sam.window_attn")
