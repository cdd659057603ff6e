"""cv2.createCLAHE(clipLimit, tileGridSize).apply on an 8-bit plane,
bit for bit, without OpenCV, on the tensor's device (the L channel of
the annotation tool's `seg_friendly`, cartseg_tpu/tools/annotate.py:54).

OpenCV's CLAHE (imgproc/src/clahe.cpp, the 8-bit path):
  * an image that the tile grid does not divide is padded with
    BORDER_REFLECT_101 at the bottom and right by tiles - (size % tiles)
    in BOTH directions (so by a whole extra tile per row or column where
    that size did divide), and the tiles are cut from the padded image;
  * each tile's 256-bin histogram is clipped at
    max(int(clip * tile_area / 256), 1); the clipped count is spread as
    clipped // 256 to every bin, then one more to each of the first
    `residual` bins of stride max(256 // residual, 1);
  * a tile's LUT is saturate(rint(cumsum * (255.f / tile_area))) in
    float32;
  * each pixel of the unpadded image blends the LUTs of its four nearest
    tile centres in float32, (lut11 * (1 - xa) + lut12 * xa) * (1 - ya) +
    (lut21 * (1 - xa) + lut22 * xa) * ya, with xa = x / tile_w - 0.5 less
    its floor (and ya likewise), the tile indices clamped to the grid,
    then saturate(rint(.)).
The histograms are one bincount over (tile, value), the LUTs a cumsum,
the blend gathers: plain torch ops, no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from cartseg_tpu_torch.ops.filters import reflect101_index


def _axis(n: int, tile: int, tiles: int, device):
    """(low tile, high tile, weight of the high one, weight of the low
    one) along one axis of n pixels, float32 as OpenCV computes them."""
    inv = np.float32(1) / np.float32(tile)
    pos = np.arange(n).astype(np.float32) * inv - np.float32(0.5)
    lo = np.floor(pos).astype(np.int64)
    a = (pos - lo.astype(np.float32)).astype(np.float32)
    a1 = (np.float32(1) - a).astype(np.float32)
    hi = np.minimum(lo + 1, tiles - 1)
    lo = np.maximum(lo, 0)
    return tuple(torch.from_numpy(t).to(device) for t in (lo, hi, a, a1))


def clahe_u8(plane: torch.Tensor, clip_limit: float = 4.0,
             tiles=(4, 4)) -> torch.Tensor:
    """CLAHE of a uint8 [H, W] tensor with `tiles` = (tiles_x, tiles_y),
    cv2's tileGridSize order, on its device."""
    if plane.dtype != torch.uint8 or plane.dim() != 2:
        raise ValueError(f"clahe_u8 takes uint8 [H, W], got {plane.dtype} "
                         f"{tuple(plane.shape)}")
    tx, ty = int(tiles[0]), int(tiles[1])
    h, w = plane.shape
    dev = plane.device
    src = plane
    if h % ty or w % tx:
        rows = torch.from_numpy(_pad_index(h, ty - h % ty)).to(dev)
        cols = torch.from_numpy(_pad_index(w, tx - w % tx)).to(dev)
        src = plane.index_select(0, rows).index_select(1, cols)
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0

    # [ty, tx, 256] histograms
    tile_id = (torch.arange(ty, device=dev).repeat_interleave(th)[:, None]
               * tx + torch.arange(tx, device=dev).repeat_interleave(tw))
    keys = tile_id * 256 + src.long()
    hist = torch.bincount(keys.reshape(-1), minlength=ty * tx * 256)
    hist = hist.reshape(ty * tx, 256)
    if limit > 0:
        clipped = (hist - limit).clamp_(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=limit) + clipped // 256
        residual = clipped - (clipped // 256) * 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        k = torch.arange(256, device=dev)
        hist = hist + ((k % step == 0) & (k // step < residual)).long()
    scale = float(np.float32(255) / np.float32(area))
    luts = torch.round(hist.cumsum(1).to(torch.float32) * scale)
    luts = luts.clamp_(0, 255).reshape(ty, tx, 256)

    y1, y2, ya, ya1 = _axis(h, th, ty, dev)
    x1, x2, xa, xa1 = _axis(w, tw, tx, dev)
    v = plane.long()
    a = luts[y1[:, None], x1[None, :], v]
    b = luts[y1[:, None], x2[None, :], v]
    c = luts[y2[:, None], x1[None, :], v]
    d = luts[y2[:, None], x2[None, :], v]
    res = (a * xa1 + b * xa) * ya1[:, None] + (c * xa1 + d * xa) * ya[:, None]
    return torch.round(res).clamp_(0, 255).to(torch.uint8)


def _pad_index(n: int, extra: int) -> np.ndarray:
    """Source rows of n + extra under BORDER_REFLECT_101 at the end."""
    return reflect101_index(n, extra)[extra:]
