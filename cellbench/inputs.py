"""Seeded inputs, made on the device.

Frames are smooth colour blobs: uniform noise on a coarse grid, resized
bilinearly to the frame size and scaled to uint8 (the recipe of the
JAX package's bench, rewritten here in torch), so that Canny finds real
edges and the thresholded probabilities form components of many sizes.
Masks are the same recipe on one channel, thresholded at one half.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def blob_frames(gen: torch.Generator, n: int, size: int, grid: int,
                device) -> torch.Tensor:
    """uint8 [n, size, size, 3] frames, NHWC."""
    base = torch.rand((n, 3, grid, grid), generator=gen, device=device)
    up = F.interpolate(base, size=(size, size), mode="bilinear",
                       align_corners=False)
    return (up * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def blob_masks(gen: torch.Generator, n: int, size: int, grid: int,
               device) -> torch.Tensor:
    """float32 {0, 1} [n, size, size, 1] masks."""
    base = torch.rand((n, 1, grid, grid), generator=gen, device=device)
    up = F.interpolate(base, size=(size, size), mode="bilinear",
                       align_corners=False)
    return (up > 0.5).to(torch.float32).permute(0, 2, 3, 1).contiguous()
