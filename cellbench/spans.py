"""The program's own spans (cartseg_tpu_torch/utils/profiling.py `span`),
read once per traced run and kept on the run's context: the driver's
profiled unit once to warm up, then UNITS units under the program's
`tracing()`, ended by a sync. The per-layer metrics named `*_span_ms`,
`step_host_ms` and `outside_program_ms` read them.

A program without spans (no `tracing` in its profiling module, or no
span of the name asked) gives None, and so do the metrics."""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Optional

WARM, UNITS = 1, 8


def readings(ctx) -> Optional[SimpleNamespace]:
    """SimpleNamespace(spans: {name: {"device_ms", "host_ms", "units"}},
    wall_ms: the host ms a unit over the traced units, dropped), or None
    where the program has no span facility."""
    if not hasattr(ctx, "span_readings"):
        ctx.span_readings = _take(ctx)
    return ctx.span_readings


def _take(ctx) -> Optional[SimpleNamespace]:
    from cartseg_tpu_torch.utils import profiling

    tracing = getattr(profiling, "tracing", None)
    if tracing is None:
        return None
    unit, sync = ctx.cell.driver.profiled_unit(ctx)
    # the driver's sync waits for a card; on the CPU every call is done
    # when it returns
    wait = sync if ctx.device.type == "cuda" else (lambda: None)
    for _ in range(WARM):
        unit()
    wait()
    with tracing() as collector:
        t0 = time.perf_counter()
        for _ in range(UNITS):
            unit()
        wait()
        wall_ms = (time.perf_counter() - t0) * 1e3 / UNITS
        got = collector.read()
    return SimpleNamespace(spans=got["spans"], records=got["records"],
                           wall_ms=wall_ms, dropped=got["dropped"])


def span_ms(ctx, kind: str, name: str, clock: str = "device_ms"):
    """The median ms a unit of span `name` on `clock` (device_ms or
    host_ms) in a cell of driver `kind`; None elsewhere, or where the
    program has no such span."""
    if getattr(ctx, "kind", None) != kind:
        return None
    got = readings(ctx)
    if got is None or name not in got.spans:
        return None
    return got.spans[name][clock]
