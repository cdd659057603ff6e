"""Step timer (counterpart of cartseg_tpu/utils/profiling.py
`StepTimer`): wall-clock step stats whose rates land in the metrics
CSV. The JAX `maybe_trace` (jax.profiler) is not ported: `trace_dir`
raises NotImplementedError in the port (train/config.py). Beside it,
`device_kernels`: the kernels a call runs on the card, from
torch.profiler's trace."""

from __future__ import annotations

import time


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
