"""Step timer and traces (counterpart of cartseg_tpu/utils/profiling.py):
`StepTimer`, wall-clock step stats whose rates land in the metrics CSV,
and `maybe_trace`, the trainer's torch.profiler trace of its first epoch
under `trace_dir`. Beside them, the operations a call runs on the card:
`device_kernels`, with their device times, from torch.profiler's trace
(which can lose events), and `graph_nodes`, every one of them, from a
CUDA graph of the call."""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
import time
import warnings
from pathlib import Path


class StepTimer:
    """Wall-clock steps and images since construction or `reset`. The
    caller reads `rates()` after a host sync (the epoch's metric fetch),
    so the device work is inside the window."""

    def __init__(self):
        self.reset()

    def step(self, batch: int):
        self.steps += 1
        self.images += batch

    def rates(self):
        dt = max(time.time() - self.t0, 1e-9)
        return {"steps_per_sec": self.steps / dt,
                "images_per_sec": self.images / dt,
                "elapsed_s": dt}

    def reset(self):
        self.t0 = time.time()
        self.steps = 0
        self.images = 0


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
    import torch
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
    import torch
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
    import torch

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
