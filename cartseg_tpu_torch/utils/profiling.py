"""Spans and traces (counterpart of cartseg_tpu/utils/profiling.py).

`span(name, device)` marks a layer of the program (the pseudo-label
program's forward, cleanup and QC, the train step's augment, forward,
loss, backward and optimizer). Off, it is a flag test and a shared null
context. Under a recording torch.profiler it is a record function (a
host event), so the program's layers appear on the profiler's clock in
every trace the repo takes. Under `tracing()` it also keeps a
`SpanRecord` (host times, and CUDA events on the span's device) for the
collector to read.
`maybe_trace` is the trainer's torch.profiler trace of its first epoch
under `trace_dir`. Beside them, the operations a call runs on the card:
`device_kernels`, with their device times, from torch.profiler's trace
(which can lose events), and `graph_nodes`, every one of them, from a
CUDA graph of the call."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import re
import statistics
import tempfile
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# records a collector keeps; older ones are dropped and counted
SPAN_CAP = 4096
# a span's event under a profiler: a record function of the FUNCTION
# scope, a host event (`cpu_op`) only. `record_function`'s USER scope
# also puts a `gpu_user_annotation` over the span's kernels on the device
# timeline, which a reader of the trace's device events would count as
# device work (busy time, the operations that took most time).
_record_function = torch._C._profiler._RecordFunctionFast


@dataclasses.dataclass
class SpanRecord:
    """One closed span. `parent` and `unit` are record ids: the enclosing
    span's, and the outermost span's (one batch or one step). Host times
    are `time.perf_counter_ns()`; device times are on the same clock once
    the collector has been read: CUDA events on a card, the host interval
    on the CPU, None where no event was recorded (a CUDA-graph capture)."""
    id: int
    name: str
    parent: Optional[int]
    unit: int
    host_start_ns: int
    host_end_ns: int = 0
    device_start_ns: Optional[float] = None
    device_end_ns: Optional[float] = None
    # (device index, start event, end event) until the collector is read
    events: Optional[tuple] = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ns is None or self.device_end_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) * 1e-6


class SpanCollector:
    """The records of the spans closed under one `tracing()`, at most
    SPAN_CAP of them (`dropped` counts the older ones let go). The CUDA
    events come from a pool reused across reads; no span synchronises."""

    def __init__(self):
        self.records: collections.deque = collections.deque(maxlen=SPAN_CAP)
        self.dropped = 0
        self._ids = itertools.count()
        self._stack: list = []      # the open spans, innermost last
        self._free: Dict[int, list] = {}

    def _event(self, index: int):
        free = self._free.setdefault(index, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def _recycle(self, rec: SpanRecord) -> None:
        if rec.events is not None:
            index, *events = rec.events
            self._free.setdefault(index, []).extend(
                e for e in events if e is not None)
            rec.events = None

    def open(self, name: str, device) -> SpanRecord:
        parent = self._stack[-1] if self._stack else None
        rid = next(self._ids)
        rec = SpanRecord(rid, name, parent.id if parent else None,
                         parent.unit if parent else rid,
                         time.perf_counter_ns())
        if device is not None and device.type == "cuda":
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            start = None
            if not torch.cuda.is_current_stream_capturing():
                start = self._event(index)
                start.record(torch.cuda.current_stream(index))
            rec.events = (index, start, None)
        self._stack.append(rec)
        return rec

    def close(self, rec: SpanRecord) -> None:
        if rec.events is not None:
            index, start, _ = rec.events
            if start is not None \
                    and not torch.cuda.is_current_stream_capturing():
                end = self._event(index)
                end.record(torch.cuda.current_stream(index))
                rec.events = (index, start, end)
        rec.host_end_ns = time.perf_counter_ns()
        if rec.events is None:      # the CPU: the host interval
            rec.device_start_ns = float(rec.host_start_ns)
            rec.device_end_ns = float(rec.host_end_ns)
        self._stack.pop()
        if len(self.records) == SPAN_CAP:
            self._recycle(self.records[0])
            self.dropped += 1
        self.records.append(rec)

    def read(self) -> dict:
        """Synchronises the devices the records ran on, puts each span's
        device interval on the host clock (a reference event recorded at a
        known perf_counter_ns once the device is idle; an event's time is
        that host time less the ms from the event to the reference), and
        returns {"records": the kept records by host start, "spans": per
        span name the median over units of its device and host ms a unit
        (`summarize`), "dropped": the records let go}."""
        records = list(self.records)
        pending = [r for r in records if r.events is not None]
        refs = {}
        for index in sorted({r.events[0] for r in pending}):
            torch.cuda.synchronize(index)
            ref = torch.cuda.Event(enable_timing=True)
            t_ref = time.perf_counter_ns()
            ref.record(torch.cuda.current_stream(index))
            ref.synchronize()
            refs[index] = (t_ref, ref)
        for r in pending:
            index, start, end = r.events
            t_ref, ref = refs[index]
            if start is not None and end is not None:
                r.device_start_ns = t_ref - start.elapsed_time(ref) * 1e6
                r.device_end_ns = t_ref - end.elapsed_time(ref) * 1e6
            self._recycle(r)
        records.sort(key=lambda r: r.host_start_ns)
        return {"records": records, "spans": summarize(records),
                "dropped": self.dropped}


def summarize(records) -> Dict[str, dict]:
    """{name: {"device_ms", "host_ms", "units"}}: each span name's ms
    summed within a unit (its outermost span), the median over the units
    it appears in (device_ms None where no record has a device time)."""
    per: Dict[str, Dict[int, list]] = {}
    for r in records:
        acc = per.setdefault(r.name, {}).setdefault(r.unit, [0.0, 0.0])
        acc[1] += r.host_ms
        dev = r.device_ms
        acc[0] = None if acc[0] is None or dev is None else acc[0] + dev
    out = {}
    for name, units in per.items():
        dev = [d for d, _ in units.values() if d is not None]
        out[name] = {
            "device_ms": statistics.median(dev) if dev else None,
            "host_ms": statistics.median(h for _, h in units.values()),
            "units": len(units)}
    return out


# the collector of the open `tracing()`, None when the records are off;
# module state so that a span deep in the program needs no argument
_COLLECTOR: Optional[SpanCollector] = None
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "collector", "rf", "rec")

    def __init__(self, name, device, collector):
        self.name, self.device, self.collector = name, device, collector

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        self.rec = (self.collector.open(self.name, self.device)
                    if self.collector is not None else None)
        return self.rec

    def __exit__(self, *exc):
        if self.rec is not None:
            self.collector.close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context manager around one layer of the program. With no
    `tracing()` open and no torch.profiler recording it is a shared null
    context; under a profiler it enters a record function named `name`
    (a host event around the operators the layer launches); under
    `tracing()` it keeps a SpanRecord, with CUDA events on the current
    stream of `device` where that is a card (none while the stream
    captures a CUDA graph). It never synchronises."""
    collector = _COLLECTOR
    if collector is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, torch.device(device) if device is not None else None,
                 collector)


@contextlib.contextmanager
def tracing():
    """Turns the span records on for the block and yields their
    SpanCollector; read it (`.read()`) inside or after the block."""
    global _COLLECTOR
    collector = SpanCollector()
    before, _COLLECTOR = _COLLECTOR, collector
    try:
        yield collector
    finally:
        _COLLECTOR = before


TRACE_NAME = "epoch0.trace.json"


@contextlib.contextmanager
def maybe_trace(trace_dir, device):
    """A torch.profiler trace of the block (CPU activity, and CUDA's on a
    card), written as a Chrome trace to `trace_dir`/TRACE_NAME when the
    block ends; nothing when trace_dir is empty. Unlike the JAX function
    it catches nothing: a profiler that cannot start raises, and an
    exception of the block reaches the caller unchanged (no trace is
    written then)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    missing = [a for a in acts if a not in supported_activities()]
    if missing:
        raise RuntimeError(f"torch.profiler cannot trace {missing} here")
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_NAME))


def device_kernels(fn, calls: int = 1) -> dict:
    """{name: (launches, summed device microseconds)} of every kernel and
    copy that `calls` calls of fn run on the card, from torch.profiler's
    trace. The caller warms fn up first where its first call differs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def graph_nodes(fn) -> list:
    """(kind, symbol) of each operation one call of fn puts on the card, in
    the order the call enqueues them: fn is captured into a CUDA graph
    (not run) and the nodes are read from the graph's DOT dump
    (`parse_graph_dot`). Unlike the profiler's trace, the graph holds
    every operation of the call. fn must not wait for the card (capture
    refuses a synchronising call) and should have run once before, so
    that lazy set-up stays out of the graph."""
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:   # older torch: debug mode alone keeps the graph
        g = torch.cuda.CUDAGraph()
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "call.dot")
        with warnings.catch_warnings():   # torch warns that it dumps
            warnings.simplefilter("ignore")
            g.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("CUDAGraph.debug_dump wrote no dump")
        with open(path) as f:
            text = f.read()
    del g
    nodes = parse_graph_dot(text)
    if not nodes:
        raise RuntimeError(f"the CUDA graph's dump holds no node; it "
                           f"begins {text[:600]!r}")
    return nodes


def parse_graph_dot(text: str) -> list:
    """(kind, symbol) of each node of a CUDA graph's DOT dump
    (cudaGraphDebugDotPrint), in the dump's order: kind is the node's
    type as the dump names it (KERNEL, MEMSET, MEMCPY, ...), symbol a
    kernel's mangled name, and the kind for any other node."""
    nodes = []
    for label in re.findall(r'"graph_\d+_node_\d+"\s*\[.*?label="((?:[^"\\]'
                            r'|\\.)*)"', text, re.S):
        kind = re.match(r"[{\s]*(\w+)", label).group(1).upper()
        sym = None
        if kind == "KERNEL":   # a C++ symbol, else the name in the ID row
            sym = (re.search(r"\b(_Z\w+)", label)
                   or re.search(r"ID \|[^|]*\|\s*([^\s\\}]+)", label))
        nodes.append((kind, sym.group(1) if sym else kind))
    return nodes
