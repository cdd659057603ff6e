"""Binary morphology (counterpart of cartseg_tpu/ops/morphology.py:19-120):
the cv2 calls of the reference mask cleaners (clean_complete.py:69-103,
clean_masks.py:12-32) on [..., H, W] bool tensors, on either device.

Dilation and erosion keep cv2's border rules: nothing outside the image
for dilation, foreground outside for erosion (cv2's +inf constant
border). They are exact boolean ORs of shifted planes: each row of a
structuring element is one run of columns, so a dilation ORs the
element's distinct column runs along the rows and then shifts them
down the element's rows. The elliptical element is cv2's own rule
(`ellipse_kernel`), reproduced without OpenCV.

Hole filling labels the background with the CC kernel (ops/cuda/cc.py
on the card): border flood-fill at 4-connectivity (cv2.floodFill's
spread), small holes at 8-connectivity, as the JAX package does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cartseg_tpu_torch.ops.connected_components import (
    connected_components, per_pixel_component_any, per_pixel_component_area)
from cartseg_tpu_torch.ops.cuda.cc import _shift_fill


@functools.lru_cache(maxsize=None)
def ellipse_kernel(ksize: int) -> tuple:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (ksize, ksize)) as (dy, dx)
    offsets in raster order: r = c = ksize // 2 and, for each row i with
    dy = i - r, the columns max(c - dx, 0) .. min(c + dx + 1, ksize) - 1
    with dx = round(c * sqrt((r^2 - dy^2) / r^2)) (cv2's rule, equal to
    its element for every ksize from 1 to 39; the JAX package's fallback
    formula for a missing cv2 is not)."""
    r = c = ksize // 2
    offs = []
    for i in range(ksize):
        dy = i - r
        dx = round(c * math.sqrt((r * r - dy * dy) / (r * r))) if r else 0
        offs += [(dy, j - c)
                 for j in range(max(c - dx, 0), min(c + dx + 1, ksize))]
    return tuple(offs)


def square_kernel(ksize: int) -> tuple:
    r = ksize // 2
    return tuple((dy, dx) for dy in range(-r, ksize - r)
                 for dx in range(-r, ksize - r))


def _row_runs(ksize: int, shape: str) -> dict:
    """{dy: (lo, hi)}: each element row's run of column offsets."""
    if shape == "ellipse":
        offs = ellipse_kernel(ksize)
    elif shape == "square":
        offs = square_kernel(ksize)
    else:
        raise ValueError(f"shape must be 'ellipse' or 'square', got {shape!r}")
    runs: dict = {}
    for dy, dx in offs:
        lo, hi = runs.get(dy, (dx, dx))
        runs[dy] = (min(lo, dx), max(hi, dx))
    return runs


def dilate(mask: torch.Tensor, ksize: int = 3,
           shape: str = "ellipse") -> torch.Tensor:
    """[..., H, W] bool -> bool: out[y, x] = OR over the element's (dy, dx)
    of mask[y - dy, x - dx], nothing outside the image."""
    mask = mask.to(torch.bool)
    out = torch.zeros_like(mask)
    along = {}
    for dy, (lo, hi) in _row_runs(ksize, shape).items():
        if (lo, hi) not in along:
            h = mask
            for dx in range(lo, hi + 1):
                if dx:
                    h = h | _shift_fill(mask, 0, dx, False)
            along[(lo, hi)] = h
        out |= _shift_fill(along[(lo, hi)], dy, 0, False)
    return out


def erode(mask: torch.Tensor, ksize: int = 3,
          shape: str = "ellipse") -> torch.Tensor:
    """[..., H, W] bool -> bool, foreground outside: the dual of dilating
    the background with nothing outside."""
    return ~dilate(~mask.to(torch.bool), ksize, shape)


def morph_open(mask: torch.Tensor, ksize: int = 3,
               shape: str = "ellipse") -> torch.Tensor:
    return dilate(erode(mask, ksize, shape), ksize, shape)


def morph_close(mask: torch.Tensor, ksize: int = 7,
                shape: str = "ellipse") -> torch.Tensor:
    return erode(dilate(mask, ksize, shape), ksize, shape)


def _border(H: int, W: int, device) -> torch.Tensor:
    b = torch.zeros((H, W), dtype=torch.bool, device=device)
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = True
    return b


def fill_holes_from_border(mask: torch.Tensor) -> torch.Tensor:
    """Fill every hole: background that no 4-connected background path
    links to the border becomes foreground (clean_masks.py:12-32,
    cv2.floodFill from the border)."""
    mask = mask.to(torch.bool)
    bg = ~mask
    labels = connected_components(bg, connectivity=4)
    outside = per_pixel_component_any(
        labels, bg & _border(*mask.shape[-2:], mask.device))
    return mask | (bg & ~outside)


def fill_small_holes(mask: torch.Tensor,
                     max_hole_area_frac: float = 0.004) -> torch.Tensor:
    """Fill only 8-connected holes of at most floor(H * W * frac) pixels
    that do not touch the border (clean_complete.py:69-83). The limit is
    taken from float32(H * W * frac), as the JAX package's jnp.floor
    takes it."""
    mask = mask.to(torch.bool)
    H, W = mask.shape[-2:]
    max_area = math.floor(float(np.float32(H * W * max_hole_area_frac)))
    bg = ~mask
    labels = connected_components(bg)
    touches = per_pixel_component_any(labels, bg & _border(H, W, mask.device))
    fill = bg & (per_pixel_component_area(labels) <= max_area) & ~touches
    return mask | fill
