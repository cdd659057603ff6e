"""Step timer (counterpart of cartseg_tpu/utils/profiling.py
`StepTimer`): wall-clock step stats whose rates land in the metrics
CSV. The JAX `maybe_trace` (jax.profiler) is not ported: `trace_dir`
raises NotImplementedError in the port (train/config.py)."""

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
