"""Host-side dataset (counterpart of cartseg_tpu/data/dataset.py):
decode -> letterbox -> resize to the training resolution, uint8 out.
Augmentation and normalisation run on the device (data/augment.py).

Images and masks are read through utils/image_io (cv2 when installed,
else the PNG codec). A resize runs only when the letterboxed frame or
the mask differs from the training size, and then needs cv2
(INTER_LINEAR for images, INTER_NEAREST for masks, as the JAX dataset;
its fused C++ letterbox+resize in cartseg_tpu.native computes the same
cv2 resize). The synthetic tree writer is utils/synthetic.py
`make_png_pair_tree`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.data.pairing import Pair
from cartseg_tpu_torch.utils import image_io


def _resize(img: np.ndarray, size: Tuple[int, int], nearest: bool,
            what: str) -> np.ndarray:
    if img.shape[:2] == tuple(size):
        return img
    if not image_io.have_cv2():
        raise RuntimeError(
            f"resizing the {img.shape[1]}x{img.shape[0]} {what} to "
            f"{size[1]}x{size[0]} needs OpenCV (cv2), which is not "
            "installed; give frames whose letterbox (and masks) are "
            "already at the training size")
    import cv2

    return cv2.resize(img, (size[1], size[0]),
                      interpolation=cv2.INTER_NEAREST if nearest
                      else cv2.INTER_LINEAR)


class SegmentationDataset:
    """Indexable host dataset over Pair records.

    __getitem__ returns (image_u8 [H,W,3], mask_u8 [H,W] in {0,1}). The
    image is letterboxed (side-pad + square) then resized LINEAR; the
    mask is resized NEAREST without letterboxing (masks were made in
    letterboxed space, train_bce_dice.py:261). The JAX dataset returns
    the mask as float32; uint8 here moves a quarter of the bytes to the
    card, where the loader makes it float32.
    """

    def __init__(self, pairs: Sequence[Pair], img_size: Tuple[int, int],
                 side_padding_ratio: float = G.SIDE_PADDING_RATIO,
                 letterbox: bool = True, mask_threshold: float = 127.0):
        self.pairs = list(pairs)
        self.img_size = tuple(img_size)
        self.side_padding_ratio = side_padding_ratio
        self.letterbox = letterbox
        self.mask_threshold = mask_threshold

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        rec = self.pairs[idx]
        img = image_io.read_rgb(rec.image)
        if img is None:
            raise RuntimeError(f"Could not read image: {rec.image}")
        if self.letterbox:
            img = G.letterbox_side_pad(
                img, side_padding_ratio=self.side_padding_ratio)
        img = _resize(img, self.img_size, False, "letterboxed frame")
        if rec.mask is None:
            mask = np.zeros(self.img_size, np.uint8)
        else:
            m = image_io.read_gray(rec.mask)
            if m is None:
                raise RuntimeError(f"Could not read mask: {rec.mask}")
            m = _resize(m, self.img_size, True, "mask")
            mask = (m > self.mask_threshold).astype(np.uint8)
        return np.ascontiguousarray(img), mask

    def batch(self, indices: Sequence[int]):
        imgs, masks = zip(*(self[i] for i in indices))
        return np.stack(imgs), np.stack(masks)[..., None]
