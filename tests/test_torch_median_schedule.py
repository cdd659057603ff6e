"""The cluster route of the port's median kernel (ops/cuda/csrc/median.cu),
emulated on the CPU: `plan(N)`'s slices, each slice's histogram of the
pass's digit for the elements under each target's prefix, the histograms
summed as the cluster sums them over DSMEM, and each target's digit and
remaining rank chosen from the sum, 4 passes of 8 bits (csrc/median.cu
kBits).
The kernel runs on the card only (tests/test_torch_kernels_cuda.py holds
it against `median_rows_plain` there); this file holds its schedule
bit for bit against `median_rows_plain` and the JAX package's median
(its Pallas kernel in interpret mode, at one shape), and checks which
route `plan` picks.

No tolerance: the order statistics are exact bit patterns, and the mean
of the two middles is 0.5 * (lo + hi) in float32 on every side (np.median
rounds in float64 and is not used).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.ops.pallas.median import _median_pallas

from cartseg_tpu_torch.ops.cuda.median import (MAX_CLUSTER, MAX_SLICE,
                                               SLICE_CAP, MedianPlan, _plan,
                                               median_rows_plain, plan)
from torch_port_helpers import one_torch_thread  # noqa: F401

# the kernel's radix digits: 4 passes of 8 bits, the top bits first
DIGIT_BITS = (8, 8, 8, 8)


def _choose(prefix, rank, hist, t, shift):
    """Target t's digit and remaining rank from a summed histogram."""
    cum = np.cumsum(hist)
    digit = int(np.searchsorted(cum, rank[t], side="right"))
    rank[t] -= int(cum[digit - 1]) if digit else 0
    prefix[t] |= digit << shift


def schedule_median(x: np.ndarray, p: MedianPlan) -> np.ndarray:
    """[B,N] float32 >= 0 -> [B]: the cluster route's radix select."""
    assert p.route == "cluster"
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    n = bits.shape[1]
    out = np.empty(bits.shape[0], np.float32)
    for b, row in enumerate(bits):
        slices = [row[r * p.slice:min((r + 1) * p.slice, n)]
                  for r in range(p.cluster)]
        assert sum(len(s) for s in slices) == n
        prefix, rank = [0, 0], [(n - 1) // 2, n // 2]
        shift = 32
        for width in DIGIT_BITS:
            top, shift = shift, shift - width
            mask = 0 if top == 32 else (0xFFFFFFFF << top) & 0xFFFFFFFF
            bins = 1 << width
            tot = np.zeros((2, bins), np.int64)   # [target][digit]
            for s in slices:                      # one CTA each
                d = ((s >> shift) & (bins - 1)).astype(np.int64)
                lo = (s & mask) == prefix[0]
                hi = ~lo & ((s & mask) == prefix[1])
                tot[0] += np.bincount(d[lo], minlength=bins)
                tot[1] += np.bincount(d[hi], minlength=bins)
            # while the prefixes agree every element is a lo key
            same = prefix[0] == prefix[1]
            for t in (0, 1):
                _choose(prefix, rank, tot[1 if t == 1 and not same else 0],
                        t, shift)
        lo, hi = np.array(prefix, np.uint32).view(np.float32)
        out[b] = np.float32(0.5) * (lo + hi)
    return out


def _rows(rng, B, N):
    """|p - 0.5| * 2 rows as the path makes them, then rows with many
    duplicates, all-zero rows and rows of two values."""
    p = 1 / (1 + np.exp(-3 * rng.standard_normal((B, N))))
    x = (np.abs(p - 0.5) * 2).astype(np.float32)
    if B >= 4:
        x[1] = np.round(x[1] * 16) / 16
        x[2] = 0.0
        x[3] = np.where(x[3] > 0.5, 1.0, 0.0)
    return x


def _check(x: np.ndarray, p: MedianPlan) -> np.ndarray:
    got = schedule_median(x, p)
    want = median_rows_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_plan_at_the_path_shape():
    """N = 262144 (512^2): 8 CTAs of 32768 elements, 128 KB each."""
    assert plan(512 * 512) == MedianPlan("cluster", 8, 32768)
    assert SLICE_CAP == 32768 and MAX_CLUSTER == 8


@pytest.mark.parametrize("n,cluster", [(1, 1), (2, 1), (32768, 1),
                                       (32769, 2), (65537, 4),
                                       (200003, 8)])
def test_plan_picks_the_smallest_cluster(n, cluster):
    p = plan(n)
    assert (p.route, p.cluster) == ("cluster", cluster)
    assert p.slice == -(-n // cluster) and (p.cluster - 1) * p.slice < n


def test_plan_takes_the_stream_route_past_the_clusters_capacity():
    most = MAX_CLUSTER * MAX_SLICE
    assert plan(most) == MedianPlan("cluster", 8, MAX_SLICE)
    assert plan(most + 1) == MedianPlan("stream", 0, 0)
    assert plan(600000).route == "stream"
    with pytest.raises(ValueError):
        plan(0)


def test_schedule_matches_plain_and_jax_at_one_shape():
    """[8, 4224] with 1024-element slices forced (8 CTAs of 528): the
    path's rows, duplicates, all zeros, two values, ties that straddle two
    slices, and rows whose middles sit in different slices."""
    rng = np.random.default_rng(13)
    x = _rows(rng, 8, 4224)
    x[4] = np.sort(x[4])                 # middles at slices 3 and 4
    x[5] = 0.25
    x[5, 2000:2200] = 0.5                # the tie spans slices 3 and 4
    x[6, : 2112] = 0.75                  # lo, hi: the tie's last, 1.0
    x[6, 2112:] = 1.0
    x[7] = rng.random(4224).astype(np.float32)
    x[7, ::3] = x[7, 0]
    p = _plan(4224, slice_cap=1024)
    assert p == MedianPlan("cluster", 8, 528)
    got = _check(x, p)
    np.testing.assert_array_equal(got, np.asarray(_median_pallas(
        jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 777, 4099])
def test_schedule_any_length(n):
    """Odd and even N, N below and not a multiple of the cluster size
    (slices of 64 forced, so the last CTA's slice is ragged)."""
    x = _rows(np.random.default_rng(n), 4, n)
    _check(x, plan(n))
    p = _plan(n, slice_cap=64)
    _check(x, p)
    if n > 64:
        assert p.cluster == 8 and (p.cluster - 1) * p.slice < n


def test_schedule_empty_slices():
    """N = 9 on 8 CTAs of 2: the last three CTAs hold nothing."""
    p = _plan(9, slice_cap=1)
    assert p == MedianPlan("cluster", 8, 2)
    _check(_rows(np.random.default_rng(9), 4, 9), p)


def test_schedule_diverging_prefixes():
    """Even N whose middles differ in the first digit (0.25 against 2.0,
    and 1e-30 against 3e38): the two targets take separate histograms in
    every pass after the first."""
    x = np.array([[0.25] * 5 + [2.0] * 5,
                  [0.0] * 3 + [1e-30, 3e38] + [5.0] * 5], np.float32)
    _check(x, plan(10))
    _check(x, _plan(10, slice_cap=3))


def test_schedule_at_the_path_shape():
    """[2, 262144] on plan(262144): 8 slices of 32768; the path's rows
    and the same scaled by 0.3."""
    x = _rows(np.random.default_rng(5), 2, 512 * 512)
    _check(np.concatenate([x, x * np.float32(0.3)]), plan(512 * 512))
