"""% of a profiled window of pseudo-label batches (with their host
copies) in which no operation ran on the device: 1 - busy / window,
from torch.profiler (harness `profile_window`). None where every
profiler window came back empty."""


def read(ctx):
    prof = getattr(ctx, "profile", None)
    if getattr(ctx, "kind", None) != "pseudo_label" or prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
