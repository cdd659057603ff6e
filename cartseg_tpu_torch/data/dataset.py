"""Host-side dataset (counterpart of cartseg_tpu/data/dataset.py):
decode -> letterbox -> resize to the training resolution, uint8 out.
Augmentation and normalisation run on the device (data/augment.py).

Images and masks are read through utils/image_io for the run's device
(a JPEG on a card through nvJPEG, on the CPU through cv2; PNG through
the PNG codec or cv2). Images are letterboxed and resized by the native
C++ loader (`native.letterbox_resize`), as the JAX dataset does. Masks
are resized by cv2's INTER_NEAREST index rule
(`geometry.resize_nearest`), which the JAX dataset takes from cv2. No
step needs OpenCV. The synthetic
tree writer is utils/synthetic.py `make_png_pair_tree`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch import native
from cartseg_tpu_torch.data.pairing import Pair
from cartseg_tpu_torch.geometry import resize_nearest
from cartseg_tpu_torch.utils import image_io


class SegmentationDataset:
    """Indexable host dataset over Pair records.

    `load(idx, device)` returns (image_u8 [H,W,3], mask_u8 [H,W] in
    {0,1}), reading the files for `device`; `dataset[idx]` reads them for
    the CPU. The image is letterboxed (side-pad + square) and resized
    LINEAR in one native pass; the mask is resized NEAREST without
    letterboxing (masks were made in letterboxed space,
    train_bce_dice.py:261). The JAX dataset returns the mask as float32;
    uint8 here moves a quarter of the bytes to the card, where the loader
    makes it float32.
    """

    def __init__(self, pairs: Sequence[Pair], img_size: Tuple[int, int],
                 side_padding_ratio: float = G.SIDE_PADDING_RATIO,
                 mask_threshold: float = 127.0):
        self.pairs = list(pairs)
        self.img_size = tuple(img_size)
        self.side_padding_ratio = side_padding_ratio
        self.mask_threshold = mask_threshold

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        return self.load(idx, "cpu")

    def load(self, idx: int, device="cpu"):
        rec = self.pairs[idx]
        img = image_io.read_rgb(rec.image, device)
        if img is None:
            raise RuntimeError(f"Could not read image: {rec.image}")
        img = native.letterbox_resize(img, self.img_size,
                                      self.side_padding_ratio)
        if rec.mask is None:
            mask = np.zeros(self.img_size, np.uint8)
        else:
            m = image_io.read_gray(rec.mask, device)
            if m is None:
                raise RuntimeError(f"Could not read mask: {rec.mask}")
            m = resize_nearest(m, self.img_size)
            mask = (m > self.mask_threshold).astype(np.uint8)
        return img, mask

    def batch(self, indices: Sequence[int]):
        imgs, masks = zip(*(self[i] for i in indices))
        return np.stack(imgs), np.stack(masks)[..., None]
