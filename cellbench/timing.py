"""Timers of the benchmark: CUDA events around repeated calls, and the
profiler window of a traced run (busy time, idle share, the device
operations that took most time and the longest idle gaps).

torch.profiler drops kernel events on the H100 machines, a kernel's or
a whole window's, so a window that holds no kernel is taken again, up to
PROFILE_TRIES times with a growing pause (the retake logic of the port's
chip_smoke.py `kernel_trace`, copied here).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PROFILE_TRIES, PROFILE_PAUSE_S = 6, 0.5


def call_ms(fn: Callable, reps: int, device) -> float:
    """Mean ms a call of fn over `reps` calls after one unrecorded call:
    CUDA events on a card; the host clock around a sync-free loop on the
    CPU (dry runs only)."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(covered microseconds, the gaps between covered stretches)."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def short_name(name: str, width: int = 160) -> str:
    """A device operation's name, cut to `width` characters (a kernel's
    full name runs to thousands with its template arguments)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def _host_op_at(cpu_events, t: float) -> str:
    """The innermost host operation running at time t (us), or 'host'."""
    best, best_len = "host", None
    for name, s, e in cpu_events:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def profile_window(unit: Callable, units: int,
                   sync: Callable) -> Optional[Dict]:
    """torch.profiler over `units` calls of unit() ended by sync(): busy_s
    (the union of the device operations' intervals inside the window),
    window_s (from the window's start on the host to the end of its
    sync), and the breakdown's lists: device operations by name (cut to
    160 characters) with their summed seconds, idle gaps by the host operation running
    in their middle; None where every try came back without a device
    operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(PROFILE_TRIES):
        time.sleep(PROFILE_PAUSE_S * i)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("cellbench.window"):
                for _ in range(units):
                    unit()
                sync()
        dev, cpu, window = [], [], None
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.name == "cellbench.window":
                if e.device_type != DeviceType.CUDA:
                    window = (s, t)
            elif e.device_type == DeviceType.CUDA:
                dev.append((e.name, s, t))
            else:
                cpu.append((e.name, s, t))
        if dev and window is not None:
            break
    else:
        return None
    w0, w1 = window
    busy_us, gaps = _union_us([(max(s, w0), min(t, w1)) for _, s, t in dev
                               if t > w0 and s < w1])
    first = min(s for _, s, _ in dev)
    gaps = [(w0, max(first, w0))] + gaps + [
        (max(t for _, _, t in dev), w1)]
    totals: Dict[str, float] = {}
    for name, s, t in dev:
        key = short_name(name)
        totals[key] = totals.get(key, 0.0) + (t - s)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted((g for g in gaps if g[1] > g[0]),
                     key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n, us * 1e-6] for n, us in top],
        "idle_gaps": [[_host_op_at(cpu, 0.5 * (a + b)), (b - a) * 1e-6]
                      for a, b in longest],
    }
