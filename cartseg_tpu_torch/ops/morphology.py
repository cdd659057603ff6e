"""Binary morphology with a square structuring element (counterpart of
cartseg_tpu/ops/morphology.py:37-70), keeping cv2's border rules:
dilation sees 0 outside the image, erosion sees fg (cv2's +inf constant
border for erode). Only the square shape is on the ported path (the
QC's mask boundary); the elliptical kernels come with the cleaning
toolchain (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """[..., H, W] bool -> bool, square ksize x ksize (odd); constant 0
    outside."""
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, got {ksize}")
    H, W = mask.shape[-2:]
    x = mask.reshape(-1, 1, H, W).to(torch.float32)
    # max_pool2d pads with -inf, i.e. no fg outside the image
    y = F.max_pool2d(x, ksize, stride=1, padding=ksize // 2)
    return (y > 0).reshape(mask.shape)


def erode(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """[..., H, W] bool -> bool, square; fg outside (erosion is the dual
    of dilating the background with nothing outside)."""
    return ~dilate(~mask, ksize)
