"""ms of device time a batch in the span `pseudo_label.qc` inside
`pseudo_label_program` (QC layer: the statistics with the cleaned
fg_area), on the program's CUDA events (cellbench/spans.py)."""

from cellbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "pseudo_label", "pseudo_label.qc")
