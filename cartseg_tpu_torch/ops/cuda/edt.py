"""Jump-flood EDT: the CUDA kernels' wrapper, their schedule, and the
plain PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/edt.py (`edt_batch_pallas`), with
the semantics of the JAX XLA lane, cartseg_tpu/ops/edt.py:34-86 (1+JFA:
the distance from every pixel to the nearest True seed, sqrt(1e12) = 1e6
where a sample has no seed). A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernels (csrc/edt.cu: one
launch per residue class of the flood, then one over halo tiles) on the
schedule of `plan`, or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cartseg_tpu_torch.ops.cuda import build as B
from cartseg_tpu_torch.ops.cuda.cc import _shift_fill

_INF = 1e12
# squared distances stay exact in float32 and in int32 below this side
_MAX_SIDE = 2048


def jfa_steps(h: int, w: int) -> list:
    """k = 2^floor(log2(max(h,w)-1)) ... 1, then 1 again (`_jfa_steps`,
    cartseg_tpu/ops/pallas/edt.py:43-53)."""
    n = max(h, w)
    k = 1
    while k * 2 < n:
        k *= 2
    steps = []
    while k >= 1:
        steps.append(k)
        k //= 2
    return steps + [1]


# csrc/edt.cu: threads a block, region cells a thread at most, steps a
# stage at most; the shared memory one block can have on sm_90
THREADS = 1024
CELLS_PER_THREAD = 16
MAX_STEPS = 16
SMEM_BYTES = 232448


@dataclass(frozen=True)
class EdtPlan:
    """The kernels' schedule for an H x W flood. Stage A runs `steps_a`
    (every step >= `split`) on each residue class mod `split`, one block
    a class; stage B runs `steps_b` (the steps below `split`; none when
    split == 1) on `tile` x `tile` pixel tiles with `halo` pixels around
    them. cells_a / cells_b: 32-bit cells of one of a block's two
    shared-memory buffers."""
    split: int
    steps_a: tuple
    steps_b: tuple
    halo: int
    tile: int
    cells_a: int
    cells_b: int


def _region_cells(h: int, w: int):
    """Cells of one buffer for an h x w region in the kernels' thread
    mapping (thread t: column t % w, rows t // w + r * R, R = min(THREADS
    // w, h), r < ceil(h / R) <= CELLS_PER_THREAD), or None when it does
    not fit."""
    if h <= 0 or w <= 0:
        return 0
    if w > THREADS:
        return None
    rows = min(THREADS // w, h)
    n = -(-h // rows)
    return None if n > CELLS_PER_THREAD else n * rows * w


def _fits(shapes, smem: int):
    cells = [_region_cells(h, w) for h, w in shapes]
    if any(c is None for c in cells) or 8 * max(cells) > smem:
        return None
    return max(max(cells), 1)


def _spans(n: int, t: int, halo: int) -> set:
    """Lengths of the tiles' regions along a side of n pixels."""
    return {min(a + t + halo, n) - max(a - halo, 0) for a in range(0, n, t)}


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, smem: int = SMEM_BYTES) -> EdtPlan:
    """The split k' is the smallest power of two whose residue classes
    (ceil(h/k') x ceil(w/k') cells, two 32-bit buffers) fit one block's
    `smem` bytes and its threads; the tile is the largest power of two up
    to 128 whose region (tile + 3 * (sum of the steps below k') on each
    side, clipped to the image) fits. One stage when k' = 1."""
    steps = jfa_steps(h, w)
    kp = 1
    while True:
        shapes = {(-(-(h - ry) // kp), -(-(w - rx) // kp))
                  for ry in range(min(kp, h)) for rx in range(min(kp, w))}
        cells_a = _fits(shapes, smem)
        if cells_a is not None:
            break
        if kp >= max(h, w):
            raise ValueError(f"edt plan: no split fits {h}x{w} in {smem} B")
        kp *= 2
    steps_a = tuple(k for k in steps if k >= kp)
    steps_b = tuple(k for k in steps if k < kp)
    if max(len(steps_a), len(steps_b)) > MAX_STEPS:
        raise ValueError(f"edt plan: {len(steps)} steps at {h}x{w}")
    if not steps_b:
        return EdtPlan(kp, steps_a, (), 0, 0, cells_a, 0)
    halo = 3 * sum(steps_b)
    for tile in (128, 64, 32, 16, 8, 4, 2, 1):
        cells_b = _fits({(a, b) for a in _spans(h, tile, halo)
                         for b in _spans(w, tile, halo)}, smem)
        if cells_b is not None:
            return EdtPlan(kp, steps_a, steps_b, halo, tile, cells_a,
                           cells_b)
    raise ValueError(f"edt plan: no tile fits {h}x{w} with halo {halo} in "
                     f"{smem} B")


def edt_batch_plain(seeds: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool -> [B,H,W] float32, op for op the JAX `edt`
    (ops/edt.py:39-86) over a batch axis: int32 nearest-seed
    coordinates, float32 squared distances, the 8 candidates of a step
    applied one after another, replacement on strict `<`."""
    seeds = seeds.to(torch.bool)
    _, H, W = seeds.shape
    dev = seeds.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    by = torch.where(seeds, ys, zero)
    bx = torch.where(seeds, xs, zero)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    d2 = torch.where(seeds, torch.zeros((), device=dev), inf)
    for k in jfa_steps(H, W):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cby = _shift_fill(by, dy, dx, 0)
                cbx = _shift_fill(bx, dy, dx, 0)
                cd2 = _shift_fill(d2, dy, dx, _INF)
                nd2 = torch.where(
                    cd2 < inf,
                    ((ys - cby) ** 2 + (xs - cbx) ** 2).to(torch.float32),
                    inf)
                better = nd2 < d2
                by = torch.where(better, cby, by)
                bx = torch.where(better, cbx, bx)
                d2 = torch.where(better, nd2, d2)
    # the correctly rounded float32 sqrt (XLA's and the kernel's sqrtf):
    # torch's vectorised float32 sqrt on the CPU is off by an ulp on some
    # integers, and a float64 sqrt rounded once to float32 is exact
    # (53 >= 2*24 + 2 bits)
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def edt_batch_jfa(seeds: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool seeds -> [B,H,W] float32 distances. CUDA: the
    jump-flood kernels of csrc/edt.cu on `plan(H, W)`, one or two
    launches; CPU: `edt_batch_plain`."""
    if seeds.dim() != 3:
        raise ValueError(f"edt_batch_jfa: need [B,H,W], got "
                         f"{tuple(seeds.shape)}")
    if seeds.dtype != torch.bool:
        raise TypeError(f"edt_batch_jfa: need bool seeds, got {seeds.dtype}")
    if seeds.device.type == "cpu":
        return edt_batch_plain(seeds)
    if not seeds.is_cuda:
        raise ValueError(f"edt_batch_jfa: tensor on {seeds.device}")
    if not seeds.is_contiguous():
        raise ValueError("edt_batch_jfa: tensor must be contiguous")
    Bn, H, W = seeds.shape
    if H > _MAX_SIDE or W > _MAX_SIDE:
        raise ValueError(f"edt_batch_jfa: side above {_MAX_SIDE}: "
                         f"{tuple(seeds.shape)}")
    if seeds.numel() == 0:
        return torch.empty(seeds.shape, dtype=torch.float32,
                           device=seeds.device)
    p = plan(H, W)
    dev = seeds.device
    state = torch.empty(seeds.shape if p.steps_b else (1,),
                        dtype=torch.int32, device=dev)
    out = torch.empty(seeds.shape, dtype=torch.float32, device=dev)
    steps = (ctypes.c_int * max(len(p.steps_a) + len(p.steps_b), 1))(
        *p.steps_a, *p.steps_b)
    lib = B.load_library()
    with torch.cuda.device(dev):
        rc = lib.cartseg_edt(seeds.data_ptr(), state.data_ptr(),
                             out.data_ptr(), Bn, H, W, p.split,
                             ctypes.addressof(steps), len(p.steps_a),
                             len(p.steps_b), p.cells_a, p.tile, p.halo,
                             p.cells_b, B.stream_of(seeds))
    B.check(rc, "edt_batch_jfa")
    B.LAUNCHES["edt"] += 1
    return out
