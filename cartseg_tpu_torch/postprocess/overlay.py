"""The drawings of the pseudo-labeller's overlays and mining's preview
panels without OpenCV (cartseg_tpu/infer/pseudo_labels.py `_overlay`,
cartseg_tpu/infer/mining.py `_save_previews`), bit for bit:

  * `draw_external_contours`: cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE) of a mask and cv2.drawContours of them, through
    the native library's contours.cpp (host C++: border following is a
    sequential walk, and the overlays are a few 512^2 frames);
  * `apply_colormap_jet`: cv2.applyColorMap(COLORMAP_JET), from the
    port's own 256-entry table (cv2's 8-bit JET, RGB order).

Images are RGB here, as everywhere in the port; the JAX package's
panels are BGR only because cv2.imwrite writes BGR, and
utils/image_io.write_png writes the same file from RGB.
"""

from __future__ import annotations

import numpy as np

from cartseg_tpu_torch import native

# COLORMAP_JET's 8-bit table: rows R, G, B, 256 entries each
_JET_HEX = (
    # R
    "00" * 96
    + "02060a0e12161a1e22262a2e32363a3e42464a4e52565a5e62666a6e72767a7e"
    + "82868a8e92969a9ea2a6aaaeb2b6babec2c6caced2d6dadee2e6eaeef2f6fafe"
    + "ff" * 64
    + "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c888480"
    # G
    + "00" * 32
    + "0004080c1014181c2024282c3034383c4044484c5054585c6064686c7074787c"
    + "8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc"
    + "ff" * 64
    + "fcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c9894908c888480"
    + "7c7874706c6864605c5854504c4844403c3834302c2824201c1814100c080400"
    + "00" * 32
    # B
    + "8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fc"
    + "ff" * 64
    + "fefaf6f2eeeae6e2dedad6d2cecac6c2bebab6b2aeaaa6a29e9a96928e8a8682"
    + "7e7a76726e6a66625e5a56524e4a46423e3a36322e2a26221e1a16120e0a0601"
    + "00" * 96)
JET_RGB = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(3, 256).T


def apply_colormap_jet(u8: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(u8, cv2.COLORMAP_JET) of an HxW uint8 image, as
    RGB (cv2 returns BGR): HxWx3 uint8."""
    if u8.dtype != np.uint8 or u8.ndim != 2:
        raise ValueError(f"apply_colormap_jet takes HxW uint8, got "
                         f"{u8.dtype} {u8.shape}")
    return JET_RGB[u8]


def draw_external_contours(rgb: np.ndarray, mask01: np.ndarray,
                           colour=(255, 0, 0),
                           thickness: int = 2) -> np.ndarray:
    """A copy of `rgb` (HxWx3 uint8) with the outer contours of `mask01`
    (HxW, nonzero is foreground) drawn in `colour` at `thickness` > 1:
    cv2.drawContours(out, cv2.findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)[0], -1, colour, thickness)."""
    if mask01.shape != rgb.shape[:2]:
        raise ValueError(f"mask {mask01.shape} does not match image "
                         f"{rgb.shape}")
    out = np.array(rgb, np.uint8, order="C", copy=True)
    native.draw_contours(out, native.find_external_contours(mask01), colour,
                         thickness)
    return out
