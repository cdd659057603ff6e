"""The schedule of the CC and hysteresis-reach kernels (cartseg_tpu_torch/
ops/cuda/csrc/cc.cu), emulated in plain PyTorch and Python on the CPU,
against the port's plain versions and the JAX package's Pallas kernels.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against `cc_batch_plain` / `reach_batch_plain` there). What their
schedule does to the labels can be checked here: `_emulate` takes the
same `plan()` and repeats the kernels' steps. Per tile (`cc_tiles`): the
run starts, the unions of the first-pixel rule with the row above, the
seeds' unions with node 0, all with the smaller root winning; then the
side entries pass 1 writes (CC: links to the tile root in the label
plane, H*W on background; reach: a representative slot a component, node
0 for a seeded one, -1 on background). Per line where tiles meet
(`cc_borders`): the same rule over runs cut at the tile edges, through a
forest in "device memory". Pass 3: the tile's labels recomputed, each
root on a side resolved through that forest. Device memory starts as
garbage, as `torch.empty` leaves it, and the emulation fails on reading
an entry that no pass wrote. The order of unions does not change the
result (every root is the minimum of its set), so one order stands for
all.

Tolerance: none; labels are integers. The test images fit one block, so
small tiles are forced by handing `plan()` a small shared-memory budget
and `max_cols`: spirals, rings and noise then cross many tile rows and
columns, with ragged last tiles.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.ops.pallas.cc import cc_batch_pallas, reach_batch_pallas

from cartseg_tpu_torch.ops.cuda.cc import (MAX_COLS, SMEM_BYTES,
                                           cc_batch_plain, plan,
                                           reach_batch_plain, tile_smem)
from cartseg_tpu_torch.utils.synthetic import (blob_masks, ring_cuts_mask,
                                               spiral_mask)
from torch_port_helpers import one_torch_thread  # noqa: F401

GARBAGE = -(2 ** 30)          # what torch.empty may leave in device memory


def _find(par, x):
    while par[x] != x:
        x = par[x]
    return x


def _unite(par, a, b):
    a, b = _find(par, a), _find(par, b)
    if a != b:
        par[max(a, b)] = min(a, b)


def _first_pixel_pairs(cur, up, conn8: bool):
    """(column on the lower line, offset on the upper line) of every
    union the first-pixel rule makes between a line `cur` and the line
    `up` before it, both bool [n]: csrc/cc.cu's bit masks."""
    n = cur.shape[0]

    def shl(x):       # bit c = x[c - 1]
        return torch.cat([torch.zeros(1, dtype=torch.bool), x[:-1]])

    def shr(x):       # bit c = x[c + 1]
        return torch.cat([x[1:], torch.zeros(1, dtype=torch.bool)])

    left, ul, ur = shl(cur), shl(up), shr(up)
    if not conn8:
        return [(int(c), 0) for c in torch.nonzero(cur & up & ~(left & ul))]
    first = cur & ~left
    out = []
    for m, d in ((first & up, 0), (first & ~up & ul, -1),
                 (cur & ~up & ur, 1)):
        out += [(int(c), d) for c in torch.nonzero(m)]
    assert all(0 <= c + d < n for c, d in out)
    return out


def _tile_roots(fg, seed, conn8: bool, pitch: int):
    """cc_tiles' steps 1-3 on one tile: fg, seed bool [rows, cols] ->
    int64 [rows, cols] root ids (r * pitch + c + 1; node 0 for a seeded
    component of reach; -1 on background)."""
    rows, cols = fg.shape
    par = list(range(rows * pitch + 1))
    idx = torch.arange(cols)
    for r in range(rows):
        # each pixel's run start: one past the last background column
        start = torch.cummax(torch.where(fg[r], -1, idx), 0).values + 1
        for c in torch.nonzero(fg[r]).flatten().tolist():
            par[r * pitch + c + 1] = r * pitch + int(start[c]) + 1
    for r in range(1, rows):
        for c, d in _first_pixel_pairs(fg[r], fg[r - 1], conn8):
            _unite(par, r * pitch + c + 1, (r - 1) * pitch + c + d + 1)
    if seed is not None:
        s = seed & fg
        for r in range(rows):
            prev = torch.cat([torch.zeros(1, dtype=torch.bool), s[r, :-1]])
            for c in torch.nonzero(s[r] & ~prev).flatten().tolist():
                _unite(par, r * pitch + c + 1, 0)
    roots = torch.full((rows, cols), -1, dtype=torch.int64)
    for r in range(rows):
        for c in torch.nonzero(fg[r]).flatten().tolist():
            roots[r, c] = _find(par, r * pitch + c + 1)
    return roots


def _tiles(p, H, W):
    for ty in range(p.tiles_down):
        for tx in range(p.tiles_across):
            y0, x0 = ty * p.rows, tx * p.cols
            yield ty, tx, y0, x0, min(p.rows, H - y0), min(p.cols, W - x0)


def _sides(p, ty, tx, rows, cols):
    """(r, c, slot) of the tile's pixels on sides that face another
    tile: csrc/cc.cu `side_pixel`."""
    if ty > 0:
        yield from ((0, c, c) for c in range(cols))
    if ty + 1 < p.tiles_down:
        yield from ((rows - 1, c, p.cols + c) for c in range(cols))
    if tx > 0:
        yield from ((r, 0, 2 * p.cols + r) for r in range(rows))
    if tx + 1 < p.tiles_across:
        yield from ((r, cols - 1, 2 * p.cols + p.rows + r)
                    for r in range(rows))


class _Memory:
    """Device memory as torch.empty leaves it; reading an entry that no
    pass wrote fails."""

    def __init__(self, n):
        self.v = [GARBAGE] * n

    def __getitem__(self, i):
        assert self.v[i] != GARBAGE, f"entry {i} read before any write"
        return self.v[i]

    def __setitem__(self, i, x):
        self.v[i] = x


def _find_mem(mem, x):
    while mem[x] != x:
        x = mem[x]
    return x


def _unite_mem(mem, a, b):
    a, b = _find_mem(mem, a), _find_mem(mem, b)
    if a != b:
        mem[max(a, b)] = min(a, b)


def _emulate_image(fg, seed, p, conn8: bool):
    """One image through the three passes. CC (seed None): int32 [H, W]
    labels; reach: bool [H, W]."""
    H, W = fg.shape
    n = H * W
    reach = seed is not None
    stride = 2 * p.cols + (2 * p.rows if p.tiles_across > 1 else 0)
    mem = _Memory(p.slots if reach else n)
    out = _Memory(n)                 # reach's output, a flag a pixel

    def flat(y0, x0, t):
        rt, ct = divmod(t - 1, p.cols)
        return (y0 + rt) * W + x0 + ct

    def tile_roots(y0, x0, rows, cols):
        win = (slice(y0, y0 + rows), slice(x0, x0 + cols))
        return _tile_roots(fg[win], seed[win] if reach else None, conn8,
                           p.cols)

    # pass 1 (cc_tiles, final_pass 0)
    for ty, tx, y0, x0, rows, cols in _tiles(p, H, W):
        roots = tile_roots(y0, x0, rows, cols)
        base = 1 + (ty * p.tiles_across + tx) * stride
        sides = list(_sides(p, ty, tx, rows, cols))
        if not reach:
            for r, c, _ in sides:
                t = int(roots[r, c])
                f = (y0 + r) * W + x0 + c
                mem[f] = n if t < 0 else flat(y0, x0, t)
                if t >= 0:
                    mem[flat(y0, x0, t)] = flat(y0, x0, t)
            continue
        rep = {}
        for r, c, slot in sides:
            t = int(roots[r, c])
            if t >= 0:
                rep[t] = min(rep.get(t, 2 ** 31), base + slot)
        for r, c, slot in sides:
            t, s = int(roots[r, c]), base + slot
            mem[s] = -1 if t < 0 else (
                rep[t] if s != rep[t] else (0 if t == 0 else s))
        if ty == tx == 0:
            mem[0] = 0
        # each pixel's local answer: its root is node 0
        for r in range(rows):
            for c in range(cols):
                out[(y0 + r) * W + x0 + c] = int(roots[r, c]) == 0

    # pass 2 (cc_borders): lines of the first row of every tile row but
    # the first, then of the first column of every tile column but the
    # first; entries on the near (below / right) and far side
    bg = -1 if reach else n

    def entry(horiz, k, near, q):
        if not reach:
            return ((k * p.rows - (not near)) * W + q if horiz
                    else q * W + k * p.cols - (not near))
        if horiz:
            tx, ty = q // p.cols, k - (not near)
            return (1 + (ty * p.tiles_across + tx) * stride
                    + (0 if near else p.cols) + q - tx * p.cols)
        ty, tx = q // p.rows, k - (not near)
        return (1 + (ty * p.tiles_across + tx) * stride + 2 * p.cols
                + (0 if near else p.rows) + q - ty * p.rows)

    lines = [(True, k, W, p.cols) for k in range(1, p.tiles_down)]
    lines += [(False, k, H, p.rows) for k in range(1, p.tiles_across)]
    for horiz, k, N, S in lines:
        for pos in range(N):
            def on(near, q):
                return mem[entry(horiz, k, near, q)] != bg

            if not on(True, pos):
                continue
            sl = pos % S != 0
            sr = pos + 1 < N and (pos + 1) % S != 0
            u = on(False, pos)
            ul = pos > 0 and on(False, pos - 1)
            ur = pos + 1 < N and on(False, pos + 1)
            ll = sl and on(True, pos - 1)
            take = []
            if not conn8:
                take = [0] if u and not (ll and ul) else []
            elif not ll:
                if u:
                    take = [0] + [-1] * (ul and not sl) + [1] * (ur and not sr)
                else:
                    take = [-1] * ul + [1] * ur
            elif ur and (not u or not sr):
                take = [1]
            for d in take:
                _unite_mem(mem, entry(horiz, k, True, pos),
                           entry(horiz, k, False, pos + d))

    # pass 3 (cc_tiles, final_pass 1): reach labels a tile again only
    # when an unseeded component on a side reaches node 0 through the
    # forest; CC always
    labels = torch.full((H, W), n, dtype=torch.int32)
    for ty, tx, y0, x0, rows, cols in _tiles(p, H, W):
        base = 1 + (ty * p.tiles_across + tx) * stride
        sides = list(_sides(p, ty, tx, rows, cols))
        if reach and p.tiles_down * p.tiles_across > 1 and not any(
                mem[base + slot] >= 0
                and not out[(y0 + r) * W + x0 + c]
                and _find_mem(mem, base + slot) == 0
                for r, c, slot in sides):
            continue
        roots = tile_roots(y0, x0, rows, cols)
        final = {}
        for r, c, slot in sides:
            t = int(roots[r, c])
            if t < 0 or t in final or (reach and t == 0):
                continue
            final[t] = (_find_mem(mem, base + slot) if reach
                        else _find_mem(mem, flat(y0, x0, t)))
        for r in range(rows):
            for c in range(cols):
                t = int(roots[r, c])
                if reach:
                    out[(y0 + r) * W + x0 + c] = t == 0 or (
                        t > 0 and final.get(t, 1) == 0)
                elif t >= 0:
                    labels[y0 + r, x0 + c] = final.get(t, flat(y0, x0, t))
    if reach:
        return torch.tensor([bool(out[i]) for i in range(n)]).reshape(H, W)
    return labels


def _emulate(mask, seeds, p, conn8=True):
    return torch.stack([
        _emulate_image(mask[b], None if seeds is None else seeds[b], p,
                       conn8)
        for b in range(mask.shape[0])])


def _small_plan(H, W, reach, cols, rows):
    """A plan forced to tiles of `rows` (a power of two) x `cols` by the
    budget."""
    p = plan(H, W, reach, tile_smem(rows, min(cols, W), reach), cols)
    assert (p.rows, p.cols) == (min(rows, H), min(cols, W)), p
    return p


def _masks(kind: str) -> np.ndarray:
    r = np.random.default_rng(0)
    if kind == "noise":
        return r.random((3, 48, 64)) < 0.45
    if kind == "blobs":
        return blob_masks(r, (3, 48, 64))
    if kind == "all_fg":
        return np.ones((2, 21, 40), bool)
    if kind == "spiral":
        return spiral_mask(33)[None]
    if kind == "ring_cuts":
        return ring_cuts_mask(33)[None]
    if kind == "mixed":
        m = r.random((3, 48, 64)) < 0.45
        m[2] = False
        return m
    raise ValueError(kind)


# (tile rows, tile cols): strips (cols >= W), then tiles side by side with
# ragged last rows and columns, then one-pixel-wide tiles
TILINGS = [(4, 1024), (8, 1024), (4, 24), (2, 16), (16, 1)]


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("kind", ["noise", "blobs", "all_fg", "spiral",
                                  "ring_cuts", "mixed"])
def test_cc_schedule_bit_equal_to_plain(kind, conn, tiling):
    m = torch.from_numpy(_masks(kind))
    p = _small_plan(*m.shape[1:], False, tiling[1], tiling[0])
    got = _emulate(m, None, p, conn8=conn == 8)
    assert torch.equal(got, cc_batch_plain(m, conn))


def _weak_strong(kind: str):
    r = np.random.default_rng(5)
    if kind == "noise":
        weak = r.random((3, 40, 56)) < 0.45
        strong = weak & (r.random(weak.shape) < 0.05)
        strong[1] |= r.random(weak.shape[1:]) < 0.05     # outside weak too
        return weak, strong
    if kind == "spiral":
        weak = spiral_mask(33)[None].repeat(2, 0)
        strong = np.zeros_like(weak)
        strong[0, 0, 0] = True                 # the outer end
        strong[1, 16, 16] = True               # the centre, off the arm
        return weak, strong
    if kind == "ring_cuts":
        weak = ring_cuts_mask(33)[None]
        strong = np.zeros_like(weak)
        strong[0, 32, 32] = strong[0, 8, 8] = True
        return weak, strong
    if kind == "all_fg":
        weak = np.ones((2, 21, 40), bool)
        strong = np.zeros_like(weak)
        strong[0, 20, 39] = True
        return weak, strong
    raise ValueError(kind)


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("kind", ["noise", "spiral", "ring_cuts", "all_fg"])
def test_reach_schedule_bit_equal_to_plain(kind, tiling):
    weak, strong = map(torch.from_numpy, _weak_strong(kind))
    p = _small_plan(*weak.shape[1:], True, tiling[1], tiling[0])
    got = _emulate(weak, strong, p)
    assert torch.equal(got, reach_batch_plain(weak, strong))


def test_schedule_bit_equal_to_pallas_interpret():
    """One shape through the JAX package's Pallas kernels (interpret
    mode): CC at both connectivities and reach, on tiles of 8 x 24."""
    m = _masks("mixed")
    for conn in (8, 4):
        p = _small_plan(48, 64, False, 24, 8)
        want = np.asarray(cc_batch_pallas(jnp.asarray(m), connectivity=conn))
        got = _emulate(torch.from_numpy(m), None, p, conn8=conn == 8)
        np.testing.assert_array_equal(got.numpy(), want)
    weak = m
    strong = m & (np.random.default_rng(1).random(m.shape) < 0.05)
    p = _small_plan(48, 64, True, 24, 8)
    want = np.asarray(reach_batch_pallas(jnp.asarray(weak),
                                         jnp.asarray(strong)))
    got = _emulate(torch.from_numpy(weak), torch.from_numpy(strong), p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plans_fit_the_kernels():
    """At the path's 512^2 the tiles are 32-row strips, three blocks an
    SM; every plan fits the budget, covers the image, and keeps reach's
    slots in int32."""
    p = plan(512, 512)
    assert (p.rows, p.cols, p.tiles_down, p.tiles_across) == (32, 512, 16, 1)
    assert 3 * (p.smem + 1024) <= 233472
    for h, w in ((512, 512), (500, 512), (2048, 2048), (77, 513),
                 (513, 77), (1, 1), (1, 100000), (100000, 1), (46340, 46340)):
        for reach in (False, True):
            p = plan(h, w, reach)
            assert p.smem == tile_smem(p.rows, p.cols, reach) <= SMEM_BYTES
            assert p.cols == min(w, MAX_COLS) and 1 <= p.rows <= h
            assert p.tiles_down * p.rows >= h > (p.tiles_down - 1) * p.rows
            assert p.tiles_across * p.cols >= w
            assert p.slots < 2 ** 31
    with pytest.raises(ValueError):
        plan(4, 4, smem=16)
