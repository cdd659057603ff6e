"""Letterbox geometry (counterpart of cartseg_tpu/geometry.py:27-116).

Pure integer math in numpy, bit-equal to the JAX package's, because
masks made by one stage are consumed letterboxed by every other stage;
`letterbox_resize` letterboxes and resizes a frame in one pass of the
native C++ loader.
The reference arithmetic is `letterbox_image_with_side_padding`
(train_bce_dice.py:42-85): `round()` for the side padding and floor
division for the centring offsets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from cartseg_tpu_torch import native

SIDE_PADDING_RATIO = 0.1  # reference default, train_bce_dice.py:32


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    """All derived geometry for one original image size."""

    orig_w: int
    orig_h: int
    side_padding_ratio: float = SIDE_PADDING_RATIO

    @property
    def side_padding(self) -> int:
        # Python round() = banker's rounding, as in the reference
        return round(self.orig_w * self.side_padding_ratio)

    @property
    def padded_w(self) -> int:
        return self.orig_w + 2 * self.side_padding

    @property
    def padded_h(self) -> int:
        return self.orig_h

    @property
    def max_dim(self) -> int:
        return max(self.padded_w, self.padded_h)

    @property
    def x_offset(self) -> int:
        return (self.max_dim - self.padded_w) // 2

    @property
    def y_offset(self) -> int:
        return (self.max_dim - self.padded_h) // 2

    def content_box(self) -> Tuple[int, int, int, int]:
        """(x0, y0, x1, y1) of the original content in the square canvas."""
        x0 = self.x_offset + self.side_padding
        y0 = self.y_offset
        return x0, y0, x0 + self.orig_w, y0 + self.orig_h


def letterbox_side_pad(
    image: np.ndarray,
    padding_color: Tuple[int, int, int] = (0, 0, 0),
    side_padding_ratio: float = SIDE_PADDING_RATIO,
) -> np.ndarray:
    """Add `side_padding_ratio` horizontal padding, then square-pad.
    HxWx3 (or HxW) in, max_dim x max_dim (x3) out, same dtype."""
    image = np.asarray(image)
    spec = LetterboxSpec(orig_w=image.shape[1], orig_h=image.shape[0],
                         side_padding_ratio=side_padding_ratio)
    if image.ndim == 3:
        canvas = np.empty((spec.max_dim, spec.max_dim, image.shape[2]),
                          dtype=image.dtype)
        canvas[...] = np.asarray(padding_color[: image.shape[2]],
                                 dtype=image.dtype)
    else:
        canvas = np.full((spec.max_dim, spec.max_dim), padding_color[0],
                         dtype=image.dtype)
    x0, y0, x1, y1 = spec.content_box()
    canvas[y0:y1, x0:x1] = image
    return canvas


def letterbox_resize(image: np.ndarray, size: int,
                     side_padding_ratio: float = SIDE_PADDING_RATIO
                     ) -> np.ndarray:
    """Letterbox an HxWx3 uint8 frame (side padding, then square
    padding, colour 0) and resize it bilinearly to size x size in one
    pass of the native C++ loader (`native.letterbox_resize`, the JAX
    dataset's resize). Against the JAX pseudo-labeller's
    `letterbox_side_pad` + cv2 INTER_LINEAR it is bit-equal where the
    letterbox is an integer multiple of `size` (1280x720 -> 512^2, a
    frame whose letterbox is already size^2); elsewhere it differs by at
    most 1 LSB on a few percent of pixels when downscaling (cv2 weighs
    in 11-bit fixed point), and by more on upscales where the content
    touches the canvas edge, which cv2 replicates and this pads
    (tests/test_torch_native.py)."""
    return native.letterbox_resize(image, (size, size), side_padding_ratio)

