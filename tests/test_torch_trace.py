"""utils/profiling.py's spans: off they cost a flag test and enter
nothing; under `tracing()` they keep nested records with their parent
and unit; under torch.profiler they are host events around their
layer's operators; the pseudo-label program and the train step carry
their layers' spans, and `fit`'s trace_dir trace holds the step's. The
card case (a span under CUDA-graph capture records no event) runs with

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

from __future__ import annotations

import json

import pytest
import torch

from cartseg_tpu_torch.infer.engine import (EnsembleMember, prepare_model,
                                            pseudo_label_program)
from cartseg_tpu_torch.models.factory import build_model
from cartseg_tpu_torch.train import TrainConfig, Trainer
from cartseg_tpu_torch.utils import profiling
from cartseg_tpu_torch.utils.profiling import (SPAN_CAP, TRACE_NAME, span,
                                               tracing)

HW, BS = 32, 2
PROGRAM = ("pseudo_label.program", ("pseudo_label.forward_tta",
                                    "pseudo_label.cleanup", "pseudo_label.qc"))
STEP = ("train.step", ("train.augment", "train.forward", "train.loss",
                       "train.backward", "train.optimizer"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def program():
    torch.manual_seed(3)
    model = build_model("efficientnet-b0")
    member = EnsembleMember(prepare_model(model, "cpu"), 1.0, 0.5)
    return pseudo_label_program([member], (0.485, 0.456, 0.406),
                                (0.229, 0.224, 0.225), 8)


def _frames():
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, 256, (BS, HW, HW, 3), generator=g,
                         dtype=torch.uint8)


@pytest.fixture(scope="module")
def trainer():
    cfg = TrainConfig(encoder="resnet18", img_size=(HW, HW), batch_size=BS,
                      compute_dtype="float32", augment="train_512",
                      device="cpu", out_dir="/nonexistent")
    tr = Trainer(cfg)
    return tr, tr.init_state()


def _step(tr, st):
    g = torch.Generator().manual_seed(7)
    imgs = torch.randint(0, 256, (BS, HW, HW, 3), generator=g,
                         dtype=torch.uint8)
    masks = (torch.rand((BS, HW, HW, 1), generator=g) > 0.5).float()
    return tr.train_step(st, imgs, masks, torch.ones(BS), [1e-4] * 3,
                         [1.0] * 3, tr.group_ids(st))


def _refuse(*args, **kwargs):
    raise AssertionError("a span with its records off reached this")


def test_off_a_span_is_a_shared_null_context(program, trainer,
                                             monkeypatch):
    """No tracing() and no profiler: span() hands back one null context,
    and the program and the step enter no record function and make no
    CUDA event."""
    monkeypatch.setattr(profiling, "_record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert span("a") is span("b", "cuda") is profiling._NULL
    with span("a") as got:
        assert got is None
    program(_frames(), 0.5)
    _step(*trainer)


def test_nested_spans_keep_parent_unit_and_lie_within():
    with tracing() as col:
        for _ in range(2):
            with span("outer", "cpu"):
                with span("mid", "cpu"):
                    with span("leaf", "cpu"):
                        torch.ones(64).sum()
                with span("side"):
                    pass
        got = col.read()
    recs = got["records"]
    assert [r.name for r in recs] == ["outer", "mid", "leaf", "side"] * 2
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "outer":
            assert r.parent is None and r.unit == r.id
            continue
        parent = by_id[r.parent]
        assert parent.name == {"mid": "outer", "leaf": "mid",
                               "side": "outer"}[r.name]
        assert r.unit == parent.unit
        assert parent.host_start_ns <= r.host_start_ns \
            <= r.host_end_ns <= parent.host_end_ns
        # on the CPU the device interval is the host interval
        assert (r.device_start_ns, r.device_end_ns) == (
            r.host_start_ns, r.host_end_ns)
    assert len({r.unit for r in recs}) == 2
    assert {n: s["units"] for n, s in got["spans"].items()} == {
        "outer": 2, "mid": 2, "leaf": 2, "side": 2}
    assert got["dropped"] == 0
    assert profiling._COLLECTOR is None


def _units(recs, outer):
    units = {}
    for r in recs:
        units.setdefault(r.unit, []).append(r)
    out = []
    for members in units.values():
        (top,) = [r for r in members if r.name == outer]
        out.append((top, [r for r in members if r is not top]))
    return out


def test_the_program_records_its_three_layers(program):
    with tracing() as col:
        for _ in range(2):
            program(_frames(), 0.5)
        got = col.read()
    outer, children = PROGRAM
    units = _units(got["records"], outer)
    assert len(units) == 2
    for top, kids in units:
        assert [k.name for k in kids] == list(children)
        assert all(k.parent == top.id for k in kids)
        assert sum(k.host_ms for k in kids) <= top.host_ms


def test_the_train_step_records_its_five_layers(trainer):
    with tracing() as col:
        _step(*trainer)
        got = col.read()
    outer, children = STEP
    (top, kids), = _units(got["records"], outer)
    assert [k.name for k in kids] == list(children)
    assert all(k.parent == top.id for k in kids)
    assert sum(k.host_ms for k in kids) <= top.host_ms


def test_under_the_profiler_spans_enclose_their_operators(program):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program(_frames(), 0.5)
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    spans = {n: (s, t) for n, s, t in events if n.startswith("pseudo_")}
    assert set(spans) == {PROGRAM[0], *PROGRAM[1]}
    s0, t0 = spans[PROGRAM[0]]
    for child in PROGRAM[1]:
        s, t = spans[child]
        assert s0 <= s <= t <= t0
    # every operator of the call lies in one layer's span; the model's
    # convolutions (and the QC's Canny filters) in theirs
    ops = {child: [n for n, s, t in events if n.startswith("aten::")
                   and spans[child][0] <= s <= t <= spans[child][1]]
           for child in PROGRAM[1]}
    inside = [n for n, s, t in events if n.startswith("aten::")
              and s0 <= s <= t <= t0]
    assert sum(map(len, ops.values())) == len(inside)
    assert all(ops.values())
    assert ops["pseudo_label.forward_tta"].count("aten::convolution") >= 30
    assert profiling._COLLECTOR is None


def test_fit_trace_dir_holds_the_step_spans(tmp_path):
    from cartseg_tpu_torch.workloads import train_bce_dice

    out = tmp_path / "run"
    train_bce_dice.main(
        ["--synthetic", "--img_size", str(HW), "--batch_size", str(BS),
         "--epochs", "1", "--device", "cpu", "--encoder", "resnet18",
         "--synthetic_sessions", "2", "--synthetic_per_session", "4",
         "--out_dir", str(out), "--trace_dir", str(out / "trace")],
        log=lambda *a: None)
    events = json.loads((out / "trace" / TRACE_NAME).read_text())[
        "traceEvents"]
    names = [e.get("name", "") for e in events]
    steps = names.count(STEP[0])
    assert steps >= 1
    for child in STEP[1]:
        assert names.count(child) == steps, child


def test_the_cap_drops_the_oldest_records_and_counts_them():
    extra = 5
    with tracing() as col:
        for _ in range(SPAN_CAP + extra):
            with span("s"):
                pass
        got = col.read()
    assert len(got["records"]) == SPAN_CAP
    assert got["dropped"] == extra
    assert [r.id for r in got["records"]] == list(
        range(extra, SPAN_CAP + extra))


@pytest.mark.cuda
def test_a_span_under_graph_capture_records_no_event():
    """A traced step of spans around card work, captured into a CUDA
    graph (`graph_nodes`): the capture runs, holds the step's kernel and
    no event node, and the records carry no device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.ones((1 << 16,), device=dev)

    def step():
        with span("step", dev):
            with span("work", dev):
                x.mul_(1.0001)

    step()
    with tracing() as col:
        step()
        nodes = profiling.graph_nodes(step)
        got = col.read()
    assert [k for k, _ in nodes] == ["KERNEL"]
    (warm_step, warm_work, cap_step, cap_work) = got["records"]
    assert warm_step.device_ms is not None and warm_work.device_ms is not None
    assert warm_step.device_ms >= warm_work.device_ms
    assert cap_step.device_ms is None and cap_work.device_ms is None
    assert cap_work.parent == cap_step.id


@pytest.mark.cuda
def test_on_the_card_a_span_is_a_host_event_only():
    """Under torch.profiler with CUDA activity a span is a host event and
    no device event bears its name: a reader of the trace's device events
    (busy time, the operations that took most time) sees the kernels
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.ones((1 << 20,), device=dev)
    with span("outer", dev):
        x.mul_(1.0001)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("outer", dev):
            with span("inner", dev):
                for _ in range(4):
                    x.mul_(1.0001)
        torch.cuda.synchronize()
    host = {e.name for e in prof.events() if e.device_type != DeviceType.CUDA}
    card = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert {"outer", "inner"} <= host
    assert not {"outer", "inner"} & card
