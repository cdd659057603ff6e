"""CC labeling and hysteresis reach: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of cartseg_tpu/ops/pallas/cc.py (`cc_batch_pallas`,
`reach_batch_pallas`). A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernels (csrc/cc.cu: tile
labelling in shared memory, links where tiles meet, resolution; one
launch when an image fits one tile, else three) on the tiles of `plan`,
or raises. Nothing falls back.

The plain versions port the JAX XLA lane's algorithm
(cartseg_tpu/ops/connected_components.py:115-169): segmented row and
column min-scans by shift doubling, plus diagonal hops, repeated to a
fixpoint. A straight run is crossed in one pass, so the loop needs
O(geodesic turns) sweeps, not O(diameter).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cartseg_tpu_torch.ops.cuda import build as B

# convergence checks of the plain fixpoint (two sweeps each), the JAX
# lane's max_iter (connected_components.py:115); the kernels need none
_MAX_CHECKS = 4096

# csrc/cc.cu: the dynamic shared memory of three cc_tiles blocks an SM
# (233472 bytes, 1 KB of it reserved a block), and the widest tile
SMEM_BYTES = 76800
MAX_COLS = 1024


def tile_smem(rows: int, cols: int, reach: bool) -> int:
    """Shared memory of a rows x cols tile, as csrc/cc.cu `tile_smem`
    lays it out: a bitmask of the mask (and reach's seeds), 32-bit words
    a row, then the forest over node 0 and the rows * cols pixels."""
    words = rows * -(-cols // 32)
    return 4 * (words * (2 if reach else 1) + rows * cols + 1)


@dataclass(frozen=True)
class CcPlan:
    """The kernels' tiles for an H x W image: `rows` x `cols` pixels
    (`tiles_down` x `tiles_across` of them, the last ones ragged), `smem`
    bytes of shared memory a block, and reach's `slots`: the int32
    entries of one image's forest over the tile sides that face another
    tile (node 0, then 2 * cols + 2 * rows a tile, the columns' 2 * rows
    only when tiles sit side by side)."""
    rows: int
    cols: int
    tiles_down: int
    tiles_across: int
    smem: int
    slots: int


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, reach: bool = False, smem: int = SMEM_BYTES,
         max_cols: int = MAX_COLS) -> CcPlan:
    """Tiles as wide as the image up to `max_cols` columns, as tall as
    the largest power of two of rows whose tile fits `smem` bytes (at
    most h): 32 x 512 at 512^2, 16 x 1024 at 2048^2."""
    if h < 1 or w < 1:
        raise ValueError(f"cc plan: empty {h}x{w} image")
    cols = min(w, max_cols)
    fixed = tile_smem(0, cols, reach)
    fit = (smem - fixed) // (tile_smem(1, cols, reach) - fixed)
    if fit < 1:
        raise ValueError(f"cc plan: no row of {cols} columns fits {smem} B")
    rows = min(1 << (fit.bit_length() - 1), h)
    down, across = -(-h // rows), -(-w // cols)
    slots = 1 + down * across * (2 * cols + (2 * rows if across > 1 else 0))
    if slots >= 2 ** 31:
        raise ValueError(f"cc plan: {slots} slots overflow int32")
    return CcPlan(rows, cols, down, across, tile_smem(rows, cols, reach),
                  slots)


def _shift_fill(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = x[..., i - dy, j - dx]; `fill` where that falls
    outside the plane (cartseg_tpu connected_components._shift_fill)."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def _shift_axis(x, axis: int, k: int, fill):
    return _shift_fill(x, k, 0, fill) if axis == -2 else \
        _shift_fill(x, 0, k, fill)


def _run_masks(fg: torch.Tensor, axis: int):
    """Per direction along `axis`, the shift-doubling levels:
    levels[j][i] == 'position i - sgn*2^j is in i's maximal fg run'."""
    n = fg.shape[axis]
    out = []
    for sgn in (1, -1):
        r = fg & _shift_axis(fg, axis, sgn, False)
        levels = [r]
        k = 1
        while 2 * k < n:
            r = r & _shift_axis(r, axis, sgn * k, False)
            levels.append(r)
            k *= 2
        out.append(levels)
    return out


def _run_min(lab, run_masks, size: int, axis: int):
    """Min label over each maximal contiguous fg run along `axis`."""

    def one_direction(v, levels, sgn):
        k = 1
        for r in levels:
            v = torch.where(r, torch.minimum(
                v, _shift_axis(v, axis, sgn * k, size)), v)
            k *= 2
        return v

    return torch.minimum(one_direction(lab, run_masks[0], 1),
                         one_direction(lab, run_masks[1], -1))


def _propagate_plain(fg: torch.Tensor, lab0: torch.Tensor,
                     connectivity: int) -> torch.Tensor:
    """Min-propagation fixpoint of lab0 over the fg domain: the shared
    core of labeling (lab0 = flat index) and reach (lab0 = 0 at seeds)."""
    H, W = fg.shape[-2:]
    size = H * W
    row_masks = _run_masks(fg, -1)
    col_masks = _run_masks(fg, -2)

    def sweep(lab):
        if connectivity == 8:
            m = lab
            for dy in (-1, 1):
                for dx in (-1, 1):
                    m = torch.minimum(m, _shift_fill(lab, dy, dx, size))
            lab = torch.where(fg, m, size)
        # 4-connectivity needs no hop: lateral/vertical adjacency is
        # exactly same-run membership in the scans
        lab = _run_min(lab, row_masks, size, -1)
        lab = _run_min(lab, col_masks, size, -2)
        return torch.where(fg, lab, size)

    lab = lab0
    for _ in range(_MAX_CHECKS):
        # two sweeps per convergence check, as the JAX lane
        new = sweep(sweep(lab))
        done = bool(torch.equal(new, lab))
        lab = new
        if done:
            break
    return lab


def _check_planes(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dim() != 3:
            raise ValueError(f"{name}: need [B,H,W], got {tuple(t.shape)}")
        if t.dtype != torch.bool:
            raise TypeError(f"{name}: need a bool mask, got {t.dtype}")
        if t.shape != ts[0].shape or t.device != ts[0].device:
            raise ValueError(f"{name}: inputs differ in shape or device")


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(
                f"{name}: tensor on {t.device}; the kernel takes CUDA "
                "tensors and the plain version CPU tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    H, W = ts[0].shape[-2:]
    if H * W >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {H}x{W} plane overflows int32 labels")


def cc_batch_plain(mask: torch.Tensor,
                   connectivity: int = 8) -> torch.Tensor:
    """[B,H,W] bool -> int32 labels: each fg pixel gets the minimum
    flat index (h*W + w) of its component; background gets H*W."""
    H, W = mask.shape[-2:]
    idx = torch.arange(H * W, dtype=torch.int32, device=mask.device)
    lab0 = torch.where(mask, idx.reshape(H, W), H * W)
    return _propagate_plain(mask, lab0, connectivity)


def cc_batch(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """[B,H,W] bool -> [B,H,W] int32 min-flat-index labels (H*W on
    background), 8- or 4-connectivity. CUDA: the union-find kernels of
    csrc/cc.cu on `plan(H, W)`; CPU: `cc_batch_plain`."""
    _check_planes("cc_batch", mask)
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if mask.device.type == "cpu":
        return cc_batch_plain(mask, connectivity)
    _check_cuda("cc_batch", mask)
    Bn, H, W = mask.shape
    labels = torch.empty((Bn, H, W), dtype=torch.int32, device=mask.device)
    if mask.numel() == 0:
        return labels
    p = plan(H, W)
    lib = B.load_library()
    with torch.cuda.device(mask.device):
        rc = lib.cartseg_cc_label(mask.data_ptr(), labels.data_ptr(),
                                  Bn, H, W, connectivity, p.rows, p.cols,
                                  B.aligned16(mask, labels),
                                  B.stream_of(mask))
    B.check(rc, "cc_batch")
    B.LAUNCHES["cc"] += 1
    return labels


def reach_batch_plain(weak: torch.Tensor,
                      strong: torch.Tensor) -> torch.Tensor:
    """Weak pixels 8-connected through weak pixels to a weak & strong
    seed: `_reach_kernel`'s min propagation with lab0 = 0 at seeds."""
    H, W = weak.shape[-2:]
    lab0 = torch.where(weak & strong, 0, H * W).to(torch.int32)
    lab = _propagate_plain(weak, lab0, 8)
    return weak & (lab == 0)


def reach_batch(weak: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool x2 -> [B,H,W] bool: pixels of `weak` connected to a
    `strong` pixel through weak pixels (seeds outside `weak` are
    ignored) — Canny's double-threshold hysteresis. CUDA: the labelling
    kernels of csrc/cc.cu over `weak` on `plan(H, W, reach=True)`, the
    seeds united with a node below every pixel; CPU:
    `reach_batch_plain`."""
    _check_planes("reach_batch", weak, strong)
    if weak.device.type == "cpu":
        return reach_batch_plain(weak, strong)
    _check_cuda("reach_batch", weak, strong)
    Bn, H, W = weak.shape
    out = torch.empty((Bn, H, W), dtype=torch.bool, device=weak.device)
    if weak.numel() == 0:
        return out
    p = plan(H, W, reach=True)
    slots = torch.empty((Bn, p.slots), dtype=torch.int32, device=weak.device)
    lib = B.load_library()
    with torch.cuda.device(weak.device):
        rc = lib.cartseg_reach(weak.data_ptr(), strong.data_ptr(),
                               slots.data_ptr(), out.data_ptr(), Bn, H, W,
                               p.rows, p.cols, p.slots,
                               B.aligned16(weak, strong, out),
                               B.stream_of(weak))
    B.check(rc, "reach_batch")
    B.LAUNCHES["reach"] += 1
    return out
