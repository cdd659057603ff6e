"""cv2.GaussianBlur on uint8, bit for bit, without OpenCV (the blur
inside the annotation tool's `smooth_mask`, cartseg_tpu/tools/
annotate.py:72).

OpenCV does not blur 8-bit images in floating point. It builds the
Gaussian in double precision, rounds the taps to 1/256 with error
diffusion and blurs in fixed point:
  * ksize = round(6 sigma + 1) | 1 (the 8-bit rule of
    `createGaussianKernels`);
  * the taps are rounded from the outside in: each adds the rounding
    error carried from the one before and rounds half to even; the
    centre tap is 256 minus the sum of the others, so they sum to 256
    exactly (`getGaussianKernelFixedPoint_ED`);
  * the row pass sums u8 x tap exactly in 1/256, the column pass those
    sums x tap exactly in 1/65536, and the result is
    (acc + 32768) >> 16, with BORDER_REFLECT_101 at the edges.

The taps are built on the host in float64 (`fixed_point_taps`), the
passes run as int32 shift-adds on the tensor's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

FRACTION_BITS = 8


def ksize_for(sigma: float) -> int:
    """cv2's kernel size for ksize (0, 0) on 8-bit images."""
    return int(np.rint(sigma * 3 * 2 + 1)) | 1


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_64F) for sigma > 0: the
    half-kernel's exp(-(x/2)^2 / (2 sigma^2)) on x = 2i - (n - 1), the
    centre 1, scaled by 1 / sum (getGaussianKernelBitExact)."""
    n2 = (ksize - 1) // 2
    scale2x = -0.125 / (sigma * sigma)
    half = [math.exp(float((2 * i + 1 - ksize) ** 2) * scale2x)
            for i in range(n2)]
    total = 2.0 * sum(half) + 1.0
    mul = 1.0 / total
    vals = [v * mul for v in half]
    return np.array(vals + [mul] + vals[::-1], np.float64)


@functools.lru_cache(maxsize=None)
def fixed_point_taps(sigma: float) -> tuple:
    """The int taps (1/256 units) cv2 blurs a uint8 image with at
    `sigma`, from the outside in with error diffusion; they sum to
    256."""
    k = gaussian_kernel(ksize_for(sigma), sigma)
    n = len(k)
    one = float(1 << FRACTION_BITS)
    taps = [0] * n
    err, total = 0.0, 0
    for i in range(n // 2):
        adj = k[i] * one + err
        v = round(adj)                     # half to even, as cvRound
        err = adj - v
        taps[i] = taps[n - 1 - i] = v
        total += v
    taps[n // 2] = (1 << FRACTION_BITS) - 2 * total
    return tuple(taps)


def reflect101_index(n: int, r: int) -> np.ndarray:
    """Source index of each of n + 2r padded positions (-r .. n - 1 + r)
    under BORDER_REFLECT_101 (cv2.borderInterpolate, repeated for
    offsets past the edge)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def _pass(x: torch.Tensor, taps: tuple, dim: int) -> torch.Tensor:
    """sum_j taps[j] * x[reflect(i + j - r)] along `dim`, int32, the
    symmetric taps paired."""
    r = len(taps) // 2
    n = x.shape[dim]
    idx = torch.from_numpy(reflect101_index(n, r)).to(x.device)
    p = x.index_select(dim, idx)
    acc = p.narrow(dim, r, n) * taps[r]
    for j in range(r):
        acc += (p.narrow(dim, j, n) + p.narrow(dim, 2 * r - j, n)) * taps[j]
    return acc


def gaussian_blur_u8(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(image, (0, 0), sigma) of a uint8 [..., H, W]
    tensor (each leading index one plane), on its device."""
    if image.dtype != torch.uint8:
        raise TypeError(f"gaussian_blur_u8 takes uint8, got {image.dtype}")
    if sigma <= 0:
        raise ValueError(f"sigma must be > 0, got {sigma}")
    taps = fixed_point_taps(float(sigma))
    x = image.to(torch.int32)
    rows = _pass(x, taps, x.dim() - 1)            # 1/256 units
    acc = _pass(rows, taps, x.dim() - 2)          # 1/65536 units
    return ((acc + (1 << 15)) >> 16).clamp_(0, 255).to(torch.uint8)
