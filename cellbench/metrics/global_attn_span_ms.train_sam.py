"""ms of device time a step in the spans `sam.global_attn` (global
attention layer: each global block's attention in the forward, with its
qkv and output projections, the rel-pos factors and the flash forward
call), summed over the step's four blocks, on the program's CUDA events
(cellbench/spans.py). None where the program has no such span."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "sam.global_attn")
