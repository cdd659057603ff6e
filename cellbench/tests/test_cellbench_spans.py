"""The span metrics on the tiny CPU cells: cellbench/spans.py takes the
program's spans once per traced run (one warm unit, then UNITS under
`tracing()`), every new metric of the cell returns a number, and each
unit's child spans sum to no more than their parent's host interval.
On the CPU a span's device interval is its host interval, so the
numbers here mean nothing of the card."""

import pytest
import torch

from cellbench import harness, spans
from cellbench.tests.tiny import make_root, tiny_name

SEED = 2 ** 31 + 29
# per cell: the outermost span, its children, and the metrics that read
# them (the new per-layer metrics of BENCHMARK.json, by reader)
CELLS = {
    "pseudo_label.effb0x3.bs64_512": (
        "pseudo_label.program",
        ("pseudo_label.forward_tta", "pseudo_label.cleanup",
         "pseudo_label.qc"),
        ("forward_tta_span_ms.pseudo_label", "cleanup_span_ms.pseudo_label",
         "qc_span_ms.pseudo_label", "outside_program_ms.pseudo_label")),
    "train_bce_dice.r34.bs128_512": (
        "train.step",
        ("train.augment", "train.forward", "train.loss", "train.backward",
         "train.optimizer"),
        ("augment_span_ms.train", "forward_span_ms.train",
         "loss_span_ms.train", "backward_span_ms.train",
         "optimizer_span_ms.train", "step_host_ms.train")),
    "train_abl.effb0.bs48_512": (
        "train.step",
        ("train.augment", "train.forward", "train.loss", "train.backward",
         "train.optimizer"),
        ("augment_span_ms.train", "forward_span_ms.train",
         "loss_span_ms.train", "backward_span_ms.train",
         "optimizer_span_ms.train", "step_host_ms.train")),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("cellbench_spans"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_span_metrics_of_a_traced_run(root, cell):
    outer, children, metrics = CELLS[cell]
    seen = {}

    def count_units(ctx):
        """Wraps the driver's profiled unit: its calls and their units."""
        seen["ctx"] = ctx
        seen["profiled"] = seen["units"] = 0
        driver = ctx.cell.driver
        orig = driver.profiled_unit

        def profiled_unit(c):
            seen["profiled"] += 1
            unit, sync = orig(c)

            def counted():
                seen["units"] += 1
                return unit()

            return counted, sync

        driver.profiled_unit = profiled_unit

    r = harness.run_cell(tiny_name(cell), SEED, 0.2, True, "cpu", root,
                         log=lambda m: None, hook=count_units)
    assert r["correct"] is True
    # the CPU traces no profiler window: spans.py is the only caller
    assert seen["profiled"] == 1
    assert seen["units"] == spans.WARM + spans.UNITS
    for name in metrics:
        v = r["metrics"][name]
        assert v["unit"] == "ms" and v["value"] >= 0.0, (name, v)

    got = seen["ctx"].span_readings
    assert got.dropped == 0
    assert {n: s["units"] for n, s in got.spans.items()} == {
        n: spans.UNITS for n in (outer,) + children}
    units = {}
    for rec in got.records:
        units.setdefault(rec.unit, []).append(rec)
    assert len(units) == spans.UNITS
    for recs in units.values():
        (parent,) = [x for x in recs if x.name == outer]
        kids = [x for x in recs if x is not parent]
        assert sorted(x.name for x in kids) == sorted(children)
        assert all(x.parent == parent.id for x in kids)
        assert sum(x.host_ms for x in kids) <= parent.host_ms
        assert sum(x.device_ms for x in kids) <= parent.device_ms
