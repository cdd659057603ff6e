"""OpenCV's 8-bit colour arithmetic without OpenCV, bit for bit, on the
tensor's device (the middle of the annotation tool's `seg_friendly`,
cartseg_tpu/tools/annotate.py:51-58):

  * `convert_scale_abs(x, alpha)`: cv2.convertScaleAbs(x, alpha=alpha),
    saturate(rint(|x * alpha|)) with x * alpha a float32 product;
  * `add_weighted(a, alpha, b, beta, gamma)`: cv2.addWeighted,
    saturate(rint(a * alpha + (b * beta + gamma))) in float32 (cv2 fuses
    the two multiply-adds; with products that are exact in float32, as
    1.5 and -0.5 times a byte are, the two agree everywhere);
  * `bgr_to_lab_u8` / `lab_to_bgr_u8`: cv2.cvtColor(COLOR_BGR2LAB /
    COLOR_LAB2BGR) on 8 bits, which OpenCV computes in fixed point from
    tables, not from the float formula (which differs from them on
    19 % / 3 % of all inputs). The tables and coefficients are rebuilt
    below as OpenCV builds them (imgproc/src/color_lab.cpp: the sRGB
    gamma, the cube root and its inverse in float32, the D65 matrices in
    2^12 fixed point) and the conversions are torch gathers and integer
    shifts. tests/test_torch_seg_friendly.py holds both directions
    against cv2 over all 2^24 inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F = np.float32
# OpenCV's shifts: XYZ coefficients in 2^12, the gamma table in 2^3 steps
# of 1/255, the cube-root table in 2^15
LAB_SHIFT, GAMMA_SHIFT = 12, 3
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
CBRT_TAB_SIZE = 256 * 3 // 2 * (1 << GAMMA_SHIFT)
INV_GAMMA_TAB_SIZE = 4096
BASE_SHIFT = 14                       # Lab -> XYZ in 2^14
BASE = 1 << BASE_SHIFT
AB_MIN, AB_MAX = -8145, 26871         # the range of ify +- a, b terms
SRGB_TO_XYZ = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
               0.019334, 0.119193, 0.950227)
XYZ_TO_SRGB = (3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
               0.055648, -0.204043, 1.057311)
D65 = (0.950456, 1.0, 1.088754)


def _rint(x) -> int:
    return int(np.rint(np.float64(x)))


def _gamma(x):
    """sRGB gamma in float32 (OpenCV's applyGamma on softfloat)."""
    if x <= _F(809) / _F(20000):
        return _F(x / (_F(323) / _F(25)))
    shift = _F(11) / _F(200)
    base = _F(_F(x + shift) / _F(_F(1) + shift))
    return _F(np.float64(base) ** np.float64(_F(12) / _F(5)))


def _inv_gamma(x):
    """Inverse sRGB gamma in float32 (applyInvGamma)."""
    if x <= _F(7827) / _F(2500000):
        return _F(x * (_F(323) / _F(25)))
    shift = _F(11) / _F(200)
    p = _F(np.float64(x) ** np.float64(_F(_F(1) / (_F(12) / _F(5)))))
    return _F(_F(p * _F(_F(1) + shift)) - shift)


@functools.lru_cache(maxsize=1)
def _lab_tables():
    """(gamma [256], cube root [3072], BGR -> XYZ coefficients [9]) of the
    8-bit BGR -> Lab path, as numpy int32."""
    gamma = [_rint(_F(255 << GAMMA_SHIFT) * _gamma(_F(i) / _F(255)))
             for i in range(256)]
    thresh, scale = _F(216) / _F(24389), _F(841) / _F(108)
    bias, step = _F(16) / _F(116), _F(1) / _F(255 << GAMMA_SHIFT)
    cbrt = []
    for i in range(CBRT_TAB_SIZE):
        x = _F(step * _F(i))
        # x * scale + bias is one fused rounding in OpenCV
        f = _F(np.float64(x) * np.float64(scale) + np.float64(bias)) \
            if x < thresh else _F(np.cbrt(np.float64(x)))
        cbrt.append(_rint(_F(1 << LAB_SHIFT2) * f))
    # OpenCV's softfloat cube root of 324 / 2040 lands one float32 step
    # below the correctly rounded one, at 17745.5 / 2^15 exactly, and
    # rounds to even the other way
    cbrt[324] -= 1
    coeffs = [0] * 9
    for i in range(3):
        row = SRGB_TO_XYZ[3 * i:3 * i + 3]
        # BGR input: the blue coefficient first
        for j, c in zip((2, 1, 0), row):
            coeffs[3 * i + j] = _rint((1 << LAB_SHIFT) * c / D65[i])
    return (np.array(gamma, np.int32), np.array(cbrt, np.int32),
            np.array(coeffs, np.int64))


@functools.lru_cache(maxsize=1)
def _lab_inv_tables():
    """(L -> (y, f(y)) [256, 2], f -> x or z [AB_MAX - AB_MIN], inverse
    gamma [4096], XYZ -> BGR coefficients [9]) of the 8-bit Lab -> BGR
    path (OpenCV's Lab2RGBinteger)."""
    ly = np.zeros((256, 2), np.int32)
    for i in range(256):
        if i <= 20:                    # L = i * 100 / 255 below 8
            y = _rint(_F(i * BASE * 20 * 9) / _F(17 * 29 * 29 * 29))
            ify = _rint(_F(BASE) * _F(_F(16) / _F(116)
                                      + _F(i * 5) / _F(3 * 17 * 29)))
        else:
            fy = _F(_F(i * 100 * BASE) / _F(255 * 116)
                    + _F(16 * BASE) / _F(116))
            ify = _rint(fy)
            y = _rint(_F(_F(fy * fy) * fy) / _F(BASE * BASE))
        ly[i] = y, ify

    def cdiv(a, b):                   # C's integer division
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b > 0) else -q

    ab = np.zeros(AB_MAX - AB_MIN, np.int32)
    for i in range(AB_MIN, AB_MAX):
        if i <= 3390:                  # 6 / 29 * BASE
            v = cdiv(i * 108, 841) - cdiv(cdiv(BASE * 16, 116) * 108, 841)
        else:
            v = cdiv(cdiv(i * i, BASE) * i, BASE)
        ab[i - AB_MIN] = v
    step = _F(1) / _F(INV_GAMMA_TAB_SIZE)
    inv = np.array([_rint(_F(255) * _inv_gamma(_F(step * _F(i))))
                    for i in range(INV_GAMMA_TAB_SIZE)], np.int32)
    coeffs = [0] * 9
    for i in range(3):
        c = [XYZ_TO_SRGB[i + 3 * j] for j in range(3)]
        # BGR output: the blue row first
        coeffs[i + 6] = _rint((1 << LAB_SHIFT) * c[0] * D65[i])
        coeffs[i + 3] = _rint((1 << LAB_SHIFT) * c[1] * D65[i])
        coeffs[i] = _rint((1 << LAB_SHIFT) * c[2] * D65[i])
    return ly, ab, inv, np.array(coeffs, np.int64)


@functools.lru_cache(maxsize=8)
def _on(device: torch.device, which: str):
    tabs = _lab_tables() if which == "to_lab" else _lab_inv_tables()
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's CV_DESCALE: (x + 2^(n-1)) >> n, arithmetic."""
    return (x + (1 << (n - 1))) >> n


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def bgr_to_lab_u8(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(bgr, cv2.COLOR_BGR2LAB) of a uint8 [..., 3] tensor, on
    its device."""
    if bgr.dtype != torch.uint8 or bgr.shape[-1] != 3:
        raise ValueError(f"bgr_to_lab_u8 takes uint8 [..., 3], got "
                         f"{bgr.dtype} {tuple(bgr.shape)}")
    gamma, cbrt, c = _on(bgr.device, "to_lab")
    c = c.tolist()
    lin = gamma[bgr.long()].long()
    c0, c1, c2 = lin[..., 0], lin[..., 1], lin[..., 2]
    fx, fy, fz = (cbrt[_descale(c0 * c[3 * k] + c1 * c[3 * k + 1]
                                + c2 * c[3 * k + 2], LAB_SHIFT)].long()
                  for k in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    half = 128 << LAB_SHIFT2
    lab = (_descale(l_scale * fy + l_shift, LAB_SHIFT2),
           _descale(500 * (fx - fy) + half, LAB_SHIFT2),
           _descale(200 * (fy - fz) + half, LAB_SHIFT2))
    return torch.stack([_u8(v) for v in lab], -1)


def lab_to_bgr_u8(lab: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(lab, cv2.COLOR_LAB2BGR) of a uint8 [..., 3] tensor, on
    its device."""
    if lab.dtype != torch.uint8 or lab.shape[-1] != 3:
        raise ValueError(f"lab_to_bgr_u8 takes uint8 [..., 3], got "
                         f"{lab.dtype} {tuple(lab.shape)}")
    ly, ab, inv, c = _on(lab.device, "to_bgr")
    c = c.tolist()
    v = lab.long()
    y, ify = ly[v[..., 0], 0].long(), ly[v[..., 0], 1].long()
    # a / 500 and b / 200 in 2^14, OpenCV's integer approximations
    adiv = ((5 * v[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * BASE // 500
    bdiv = ((v[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * BASE // 200 + 1
    x = ab[ify + adiv - AB_MIN].long()
    z = ab[ify - bdiv - AB_MIN].long()
    shift = LAB_SHIFT + (BASE_SHIFT - 12)
    out = []
    for k in range(3):
        lin = _descale(c[3 * k] * x + c[3 * k + 1] * y + c[3 * k + 2] * z,
                       shift)
        out.append(inv[lin.clamp(0, INV_GAMMA_TAB_SIZE - 1)].to(torch.uint8))
    return torch.stack(out, -1)


def convert_scale_abs(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """cv2.convertScaleAbs(x, alpha=alpha, beta=0) of a uint8 tensor."""
    y = (x.to(torch.float32) * float(np.float32(alpha))).abs()
    return torch.round(y).clamp_(0, 255).to(torch.uint8)


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor,
                 beta: float, gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted(a, alpha, b, beta, gamma) of two uint8 tensors."""
    if a.shape != b.shape or a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError("add_weighted takes two uint8 tensors of one shape")
    f = torch.float32
    y = a.to(f) * float(np.float32(alpha)) + (
        b.to(f) * float(np.float32(beta)) + float(np.float32(gamma)))
    return torch.round(y).clamp_(0, 255).to(torch.uint8)
