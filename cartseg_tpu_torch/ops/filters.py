"""cv2.GaussianBlur and cv2.bilateralFilter on uint8 without OpenCV
(the blur inside the annotation tool's `smooth_mask`, cartseg_tpu/tools/
annotate.py:72, and the first two stages of its `seg_friendly`,
:49-50).

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

cv2.bilateralFilter on 8-bit three-channel images is float32 (OpenCV's
`bilateralFilter_8u`, which the installed cv2 hands to IPP's
ippiFilterBilateral):
  * the taps are the offsets (i, j), rows outer, with
    sqrt(i^2 + j^2) <= r = d // 2 (149 at d = 15), each weighted
    (float)exp(r^2 * -0.5 / sigma_space^2) in double;
  * the colour weight of a tap is a 256 * 3 entry table of
    (float)exp(k^2 * -0.5 / sigma_color^2), indexed by the L1 distance
    k = |b - b0| + |g - g0| + |r - r0| to the centre pixel;
  * in tap order, w = space * colour (rounded) is added to the weight
    sum (rounded) and each channel's sum takes fma(value, w, sum), one
    rounding;
  * the output is rint(sum / weight sum), the image padded by
    BORDER_REFLECT_101.
`bilateral_u8_plain` is that loop in torch, the fused multiply-add
emulated exactly in float64 (`_fma_f32`); on a CUDA tensor
`bilateral_u8` launches csrc/bilateral.cu, which runs the same float32
operations in the same order (`__fmul_rn`, `__fadd_rn`, `__fmaf_rn`,
`__fdiv_rn`), so the two are bit-equal. IPP's quotient is not always
the correctly rounded one: on 0-2 of the 2.76M values of a 1280x720
frame, within 1e-5 of a half, it rounds the other way, and there the
two differ from cv2 by 1 (tools/seg_friendly_against_cv2.py measures
it).
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


def bilateral_tables(d: int, sigma_color: float, sigma_space: float):
    """(colour weights float32 [768], tap offsets int32 [n, 2] as (dy, dx)
    rows outer, space weights float32 [n]) of cv2.bilateralFilter on
    three 8-bit channels at (d, sigma_color, sigma_space)."""
    sigma_color = sigma_color if sigma_color > 0 else 1.0
    sigma_space = sigma_space if sigma_space > 0 else 1.0
    radius = d // 2 if d > 0 else int(np.rint(sigma_space * 1.5))
    radius = max(radius, 1)
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    colour = np.array([math.exp(i * i * gc) for i in range(256 * 3)],
                      np.float32)
    offsets, space = [], []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(i * i + j * j)
            if r > radius:
                continue
            offsets.append((i, j))
            space.append(math.exp(r * r * gs))
    return (colour, np.array(offsets, np.int32).reshape(-1, 2),
            np.array(space, np.float32))


def bilateral_u8_plain(image: torch.Tensor, d: int = 15,
                       sigma_color: float = 100.0,
                       sigma_space: float = 15.0) -> torch.Tensor:
    """cv2.bilateralFilter(image, d, sigma_color, sigma_space) of a uint8
    [H, W, 3] tensor as plain torch ops on its device: one pass of
    elementwise ops a tap, in tap order (see the module docstring)."""
    colour, offsets, space = bilateral_tables(d, sigma_color, sigma_space)
    h, w = image.shape[:2]
    r = int(np.abs(offsets).max())
    dev = image.device
    ys = torch.from_numpy(reflect101_index(h, r)).to(dev)
    xs = torch.from_numpy(reflect101_index(w, r)).to(dev)
    pad = image.to(torch.int32).index_select(0, ys).index_select(1, xs)
    centre = image.to(torch.int32)
    table = torch.from_numpy(colour).to(dev)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for (dy, dx), sw in zip(offsets.tolist(), space.tolist()):
        tap = pad[r + dy:r + dy + h, r + dx:r + dx + w]
        dist = (tap - centre).abs().sum(-1)
        wt = table[dist] * sw
        wsum = wsum + wt
        acc = _fma_f32(tap, wt.unsqueeze(-1), acc)
    return torch.round(acc / wsum.unsqueeze(-1)).clamp_(0, 255).to(
        torch.uint8)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 fma(a, b, c), one rounding, for integer a of at most 29
    bits and float32 b, c: a * b is exact in float64, the float64 sum
    t = c + a * b carries its exact error (TwoSum), and t rounded to
    float32 is the fused result unless t lies exactly halfway between
    two floats, where the error's sign picks the side."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    t = c64 + p
    z = t - c64
    err = (c64 - (t - z)) + (p - z)
    r = t.to(torch.float32)
    gap = t - r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    up, down = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    half_up = (up.to(torch.float64) - r.to(torch.float64)) / 2
    half_down = (r.to(torch.float64) - down.to(torch.float64)) / 2
    r = torch.where((gap == half_up) & (err > 0), up, r)
    return torch.where((gap == -half_down) & (err < 0), down, r)


def bilateral_u8(image: torch.Tensor, d: int = 15, sigma_color: float = 100.0,
                 sigma_space: float = 15.0) -> torch.Tensor:
    """cv2.bilateralFilter(image, d, sigma_color, sigma_space) of a uint8
    [H, W, 3] tensor on its device: the CUDA kernel (csrc/bilateral.cu)
    on a card, `bilateral_u8_plain` on the CPU."""
    if image.dtype != torch.uint8 or image.dim() != 3 or image.shape[2] != 3:
        raise ValueError("bilateral_u8 takes a uint8 [H, W, 3] tensor, got "
                         f"{image.dtype} {tuple(image.shape)}")
    if image.device.type == "cpu":
        return bilateral_u8_plain(image, d, sigma_color, sigma_space)
    from cartseg_tpu_torch.ops.cuda.bilateral import bilateral_u8_cuda

    return bilateral_u8_cuda(image, *bilateral_tables(d, sigma_color,
                                                      sigma_space))
