"""Letterbox geometry (counterpart of cartseg_tpu/geometry.py:27-168).

Pure integer math in numpy, bit-equal to the JAX package's, because
masks made by one stage are consumed letterboxed by every other stage;
`letterbox_resize` letterboxes and resizes a frame in one pass of the
native C++ loader, and `remove_letterbox` undoes the letterbox of a
mask with cv2 INTER_NEAREST's index rule (`resize_nearest`), without
OpenCV.
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

    def content_box_resized(self, final_w: int,
                            final_h: int) -> Tuple[int, int, int, int]:
        """The content box after the square canvas was resized to
        (final_w, final_h): scaled, rounded with round(), clamped
        (`calculate_content_boundaries`, clean_complete.py:35-57)."""
        x0, y0, x1, y1 = self.content_box()
        sx = final_w / self.max_dim
        sy = final_h / self.max_dim
        X0, X1 = (max(0, min(final_w, int(round(v * sx)))) for v in (x0, x1))
        Y0, Y1 = (max(0, min(final_h, int(round(v * sy)))) for v in (y0, y1))
        return X0, Y0, X1, Y1


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


def calculate_content_boundaries(
    orig_w: int, orig_h: int, final_w: int, final_h: int,
    side_padding_ratio: float = SIDE_PADDING_RATIO,
) -> Tuple[int, int, int, int]:
    """The content box (x0, y0, x1, y1) in a resized letterboxed frame
    (clean_complete.py:35-57, remove_padding_from_masks.py:26-52)."""
    return LetterboxSpec(orig_w, orig_h,
                         side_padding_ratio).content_box_resized(final_w,
                                                                 final_h)


def cut_mask_padding(mask: np.ndarray, orig_w: int, orig_h: int,
                     side_padding_ratio: float = SIDE_PADDING_RATIO
                     ) -> np.ndarray:
    """Zero everything outside the letterbox content box of a 2-D mask
    of any dtype (clean_complete.py:59-65)."""
    H, W = mask.shape[:2]
    x0, y0, x1, y1 = calculate_content_boundaries(
        orig_w, orig_h, W, H, side_padding_ratio)
    out = np.zeros_like(mask)
    if x1 > x0 and y1 > y0:
        out[y0:y1, x0:x1] = mask[y0:y1, x0:x1]
    return out


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index of each destination index:
    floor(i * (1 / (dst / src))) in double precision, clamped to src - 1.
    Equal to cv2.resize on every size pair tried (tests/
    test_torch_native.py); the integer floor(i * src / dst) and
    `native.resize_nearest` differ from it at some pairs."""
    idx = np.floor(np.arange(n_dst) * (1.0 / (n_dst / n_src)))
    return np.minimum(idx.astype(np.int64), n_src - 1)


def resize_nearest(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST) of an
    HxW array, without OpenCV."""
    h, w = mask.shape[:2]
    if (h, w) == tuple(size):
        return mask
    return np.ascontiguousarray(
        mask[_nearest_index(h, size[0])[:, None],
             _nearest_index(w, size[1])[None, :]])


def remove_letterbox(mask: np.ndarray, orig_w: int, orig_h: int,
                     side_padding_ratio: float = SIDE_PADDING_RATIO,
                     interpolation: str = "nearest") -> np.ndarray:
    """Inverse letterbox: crop the content box of a (resized) letterboxed
    mask and resize it to orig_h x orig_w (remove_padding_from_masks.py:
    54-68). "nearest" is cv2 INTER_NEAREST's rule, bit for bit, without
    OpenCV; any other `interpolation` is cv2 INTER_LINEAR, which is not
    reproduced and needs cv2."""
    H, W = mask.shape[:2]
    x0, y0, x1, y1 = calculate_content_boundaries(
        orig_w, orig_h, W, H, side_padding_ratio)
    content = mask[y0:y1, x0:x1]
    if content.size == 0:
        return np.zeros((orig_h, orig_w), dtype=mask.dtype)
    if interpolation == "nearest":
        return np.ascontiguousarray(resize_nearest(content,
                                                   (orig_h, orig_w)))
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"remove_letterbox(interpolation={interpolation!r}) resizes "
            "with cv2 INTER_LINEAR and needs OpenCV (cv2), which is not "
            "installed; interpolation='nearest' needs none") from e
    return cv2.resize(content, (orig_w, orig_h),
                      interpolation=cv2.INTER_LINEAR)


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

