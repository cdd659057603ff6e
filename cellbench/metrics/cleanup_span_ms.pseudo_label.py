"""ms of device time a batch in the span `pseudo_label.cleanup` inside
`pseudo_label_program` (CC cleanup layer: `remove_small_components`),
on the program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "pseudo_label", "pseudo_label.cleanup")
