"""ms of device time a batch in the span `pseudo_label.forward_tta` inside
`pseudo_label_program` (model layer: the ensemble's forward with flip
TTA), on the program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "pseudo_label", "pseudo_label.forward_tta")
