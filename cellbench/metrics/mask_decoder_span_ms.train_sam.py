"""ms of device time a step in the span `sam.mask_decoder` (mask decoder
layer: the box prompts' embedding, the two-way mask decoder and the
upsample of the logits to the frame size) in the forward, on the
program's CUDA events (cellbench/spans.py). None where the program has
no such span."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "sam.mask_decoder")
