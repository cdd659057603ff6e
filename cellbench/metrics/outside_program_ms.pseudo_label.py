"""ms a batch outside `pseudo_label_program` (host loop layer): the wall
ms a unit of the driver's loop (the program and the workload's host
copies of pred, probs and stats) less the mean device ms a unit of the
span `pseudo_label.program` (cellbench/spans.py). Both are means over
the same traced units, so the difference cannot go below 0 where the
program's calls vary, as a median against the wall's mean could."""

from cellbench.spans import readings, span_ms


def read(ctx):
    if span_ms(ctx, "pseudo_label", "pseudo_label.program") is None:
        return None
    got = readings(ctx)
    program = [r.device_ms for r in got.records
               if r.name == "pseudo_label.program"]
    return got.wall_ms - sum(program) / len(program)
