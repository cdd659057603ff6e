"""The schedule of the jump-flood EDT kernels (cartseg_tpu_torch/ops/cuda/
csrc/edt.cu), emulated in plain PyTorch on the CPU, against the port's
plain EDT.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against `edt_batch_plain` there). What their schedule does to the
flood can be checked here: `_emulate` below takes the same `plan()` and
repeats the kernels' arithmetic: the offsets to the seeds in fp16
("no seed" the offset (0, 16384), which a candidate from outside the
region reads too), each candidate an fp16 add, fp32 squared distances,
stage A on each residue class mod the split (the class neighbour at
(dy/k', dx/k') standing in for (dy, dx)), then stage B on tiles with
their halo, writing only the tile. `edt_batch_plain` is bit-
equal to JAX's `edt_batch` (tests/test_torch_edt.py), so this holds the
kernels' schedule against the JAX package.

Tolerance: none. For every pixel with a seed both sides compute the
same integers (an offset to a seed is at most 2047, exact in fp16, and
its d^2 below 2^23, exact in fp32) and the same correctly rounded sqrt,
so the maps are compared bit for bit. The
images here fit one block, so the split is forced by handing `plan()` a
small shared-memory budget.
"""

import numpy as np
import pytest
import torch

from cartseg_tpu_torch.ops.cuda.cc import _shift_fill
from cartseg_tpu_torch.ops.cuda.edt import (CELLS_PER_THREAD, SMEM_BYTES,
                                            THREADS, edt_batch_plain,
                                            jfa_steps, plan)
from cartseg_tpu_torch.utils.synthetic import edt_seeds
from torch_port_helpers import one_torch_thread  # noqa: F401

NO_SEED_Y = 16384.0   # "no seed": the offset (ox, oy) = (0, 16384)
NO_SEED_D2 = 2.0 ** 24


def _d2(ox: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """fp32 fmaf(ox, ox, oy * oy): ox * ox is exact, so one rounding of the
    sum, as the FMA."""
    fx, fy = ox.float(), oy.float()
    return fx * fx + fy * fy


def _flood(ox, oy, steps, s: int):
    """The kernels' flood on [B, h, w] regions of fp16 offsets whose cells
    are s pixels apart; a candidate outside the region reads "no seed"."""
    d2 = _d2(ox, oy)
    for k in steps:
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                a, b = dy // s, dx // s
                # fp16 adds, rounded to nearest as the half2 add
                cx = _shift_fill(ox, a, b, 0.0) + torch.tensor(
                    dx, dtype=torch.float16)
                cy = _shift_fill(oy, a, b, NO_SEED_Y) + torch.tensor(
                    dy, dtype=torch.float16)
                nd = _d2(cx, cy)
                better = nd < d2
                ox = torch.where(better, cx, ox)
                oy = torch.where(better, cy, oy)
                d2 = torch.where(better, nd, d2)
    return ox, oy


def _finish(ox, oy) -> torch.Tensor:
    d2 = _d2(ox, oy)
    d = torch.where(d2 >= NO_SEED_D2, 1e12, d2.to(torch.float64))
    return torch.sqrt(d).to(torch.float32)


def _emulate(seeds: torch.Tensor, p) -> torch.Tensor:
    """[B,H,W] bool -> [B,H,W] float32 through plan p's two stages."""
    _, H, W = seeds.shape
    kp = p.split
    ox = torch.zeros(seeds.shape, dtype=torch.float16)
    oy = torch.where(seeds, 0.0, NO_SEED_Y).to(torch.float16)
    for ry in range(min(kp, H)):
        for rx in range(min(kp, W)):
            cls = (slice(None), slice(ry, None, kp), slice(rx, None, kp))
            ox[cls], oy[cls] = _flood(ox[cls].clone(), oy[cls].clone(),
                                      p.steps_a, kp)
    if not p.steps_b:
        return _finish(ox, oy)
    out = torch.full(seeds.shape, float("nan"))
    T, h = p.tile, p.halo
    for ty in range(0, H, T):
        for tx in range(0, W, T):
            y0, x0 = max(ty - h, 0), max(tx - h, 0)
            y1, x1 = min(ty + T + h, H), min(tx + T + h, W)
            region = (slice(None), slice(y0, y1), slice(x0, x1))
            rx_, ry_ = _flood(ox[region].clone(), oy[region].clone(),
                              p.steps_b, 1)
            tile = (slice(None), slice(ty - y0, ty - y0 + T),
                    slice(tx - x0, tx - x0 + T))
            out[:, ty:ty + T, tx:tx + T] = _finish(rx_[tile], ry_[tile])
    return out


def _seeds(shape, seed=0) -> torch.Tensor:
    """chip_smoke.py's kinds of seeds at `shape` [B,H,W], B = 7: GT
    boundaries of blob masks, then a sample with no seed, one with a
    single seed, one with every pixel a seed and a sparse random one."""
    return torch.from_numpy(edt_seeds(np.random.default_rng(seed), shape,
                                      n=3))


def test_plans_fit_the_kernels():
    """At every side the wrapper takes (up to 2048) the plan fits the
    block's threads and shared memory, at most two launches, and the
    path's 512^2 flood splits mod 4 with a 12-pixel halo."""
    for h, w in ((512, 512), (400, 512), (2048, 2048), (1, 2048),
                 (2048, 1), (1000, 1500), (170, 170), (37, 53), (1, 1)):
        p = plan(h, w)
        assert p.steps_a + p.steps_b == tuple(jfa_steps(h, w))
        assert all(k >= p.split for k in p.steps_a)
        assert all(k < p.split for k in p.steps_b)
        assert 8 * max(p.cells_a, p.cells_b) <= SMEM_BYTES
        assert max(p.cells_a, p.cells_b) <= THREADS * CELLS_PER_THREAD
        assert p.halo == 3 * sum(p.steps_b)
        assert (p.tile > 0) == bool(p.steps_b)
    p = plan(512, 512)
    assert (p.split, p.steps_b, p.halo, p.tile) == (4, (2, 1, 1), 12, 64)
    assert plan(37, 53).split == 1


@pytest.mark.parametrize("shape", [(7, 37, 53), (7, 1, 77), (7, 77, 1),
                                   (7, 1, 1)])
def test_one_stage_schedule_bit_equal_to_plain(shape):
    """Images that fit one block: the whole flood in stage A."""
    s = _seeds(shape)
    p = plan(*shape[1:])
    assert p.split == 1 and not p.steps_b
    assert torch.equal(_emulate(s, p), edt_batch_plain(s))


@pytest.mark.parametrize("shape,smem,split,tile",
                         [((7, 96, 128), 64 * 1024, 2, 64),
                          ((7, 200, 160), 20000, 4, 16),
                          ((7, 37, 53), 6000, 2, 8)])
def test_split_schedule_bit_equal_to_plain(shape, smem, split, tile):
    """A small budget forces the split: residue classes mod 2 or 4 (ragged
    where a side is not a multiple of it), then halo tiles."""
    s = _seeds(shape, seed=1)
    p = plan(*shape[1:], smem=smem)
    assert (p.split, p.tile) == (split, tile) and p.halo > 0
    got = _emulate(s, p)
    assert torch.equal(got, edt_batch_plain(s))
    assert torch.all(got[3] == 1e6) and torch.all(got[5] == 0)


def test_tiles_need_their_halo():
    """The halo is not slack: without it, stage B's tiles miss candidates
    across their edges and the map changes."""
    s = _seeds((7, 96, 128), seed=1)
    p = plan(96, 128, smem=64 * 1024)
    bare = type(p)(**{**p.__dict__, "halo": 0})
    assert not torch.equal(_emulate(s, bare), edt_batch_plain(s))
