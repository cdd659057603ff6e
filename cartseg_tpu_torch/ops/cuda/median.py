"""Exact median over the last axis: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/median.py
(`median_nonneg_last_axis`). np.median semantics: the mean of the two
middle order statistics for even N, computed as 0.5 * (lo + hi) in
fp32. `torch.median` returns the lower middle for even N and is not
used.

Precondition: values are non-negative (the kernel selects on the int32
bit patterns, whose order equals the float order only there). The one
caller feeds |p - 0.5| * 2.

The kernel (csrc/median.cu) has two routes, and `plan(N)` picks one from
the row length before the launch: a row that a thread-block cluster's
shared memory holds goes to the cluster route (one launch, each row read
once), a longer one to the stream route (4 passes over device memory).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cartseg_tpu_torch.ops.cuda import build as B

_BINS = 256
# the most elements a cluster-route CTA holds, compiled into the kernel
MAX_SLICE = B.DEFINES["CARTSEG_MEDIAN_MAX_SLICE"]
# the largest cluster the route launches (1 to 8 are portable on Hopper)
MAX_CLUSTER = 8
# the slice `plan` aims for: 32768 floats (128 KB, one CTA an SM), so a
# cluster of 8 holds the path's 262144-element row
SLICE_CAP = 32768


@dataclass(frozen=True)
class MedianPlan:
    """`route` "cluster": `cluster` CTAs a row, each holding `slice`
    elements of it in shared memory (the last CTA's slice is ragged or
    empty); "stream": 4 passes over device memory (cluster and slice 0).
    """
    route: str
    cluster: int
    slice: int


def plan(n: int) -> MedianPlan:
    """The smallest power-of-two cluster (up to MAX_CLUSTER) whose slices
    of ceil(n / cluster) elements stay within SLICE_CAP; past that,
    MAX_CLUSTER CTAs with slices up to MAX_SLICE; past that, the stream
    route. N = 262144: 8 CTAs of 32768."""
    return _plan(n, SLICE_CAP)


def _plan(n: int, slice_cap: int) -> MedianPlan:
    """`plan` at another slice cap (tests force small slices with it)."""
    if n < 1:
        raise ValueError(f"median plan: empty row (N = {n})")
    cluster = 1
    while cluster < MAX_CLUSTER and -(-n // cluster) > slice_cap:
        cluster *= 2
    per = -(-n // cluster)
    if per > MAX_SLICE:
        return MedianPlan("stream", 0, 0)
    return MedianPlan("cluster", cluster, per)


def median_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """[B,N] -> [B]: sort, take k_lo = (N-1)//2 and k_hi = N//2."""
    n = x.shape[-1]
    s, _ = torch.sort(x, dim=-1)
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """[B,N] float32 >= 0 -> [B] exact medians. CUDA: radix-select
    kernel (csrc/median.cu) on `plan(N)`'s route; CPU:
    `median_rows_plain`."""
    if x.dim() != 2 or x.shape[-1] == 0:
        raise ValueError(f"median_rows: need [B,N>0], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"median_rows: need float32, got {x.dtype}")
    if x.device.type == "cpu":
        return median_rows_plain(x)
    if not x.is_cuda:
        raise ValueError(f"median_rows: tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("median_rows: tensor must be contiguous")
    Bn, n = x.shape
    if Bn > 65535 or n >= 2 ** 31:
        raise ValueError(f"median_rows: shape {tuple(x.shape)} too large")
    return _launch(x, plan(n))


def _launch(x: torch.Tensor, p: MedianPlan) -> torch.Tensor:
    """Launch the kernel on plan `p` (median_rows' checks done; tests
    launch forced plans with it)."""
    Bn, n = x.shape
    out = torch.empty((Bn,), dtype=torch.float32, device=x.device)
    if p.route == "stream":
        hist = torch.empty((Bn, 2, _BINS), dtype=torch.int32,
                           device=x.device)
        state = torch.empty((Bn, 2, 3), dtype=torch.int32, device=x.device)
        scratch = (hist.data_ptr(), state.data_ptr())
    else:
        scratch = (None, None)
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_median_nonneg(x.data_ptr(), *scratch,
                                       out.data_ptr(), Bn, n, p.cluster,
                                       p.slice, B.stream_of(x))
    B.check(rc, "median_rows")
    B.LAUNCHES["median"] += 1
    return out


def median_nonneg_last_axis(x: torch.Tensor) -> torch.Tensor:
    """[..., N] non-negative float32 -> [...] exact median over the
    last axis."""
    shape = x.shape
    return median_rows(x.reshape(-1, shape[-1]).contiguous()).reshape(
        shape[:-1])
