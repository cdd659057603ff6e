"""Inverse letterbox over mask trees, and preview overlays (counterpart
of cartseg_tpu/postprocess/unpad.py; reference
remove_padding_from_masks.py): crop the content box of a (resized)
letterboxed mask and resize it back to the original image's size
(:54-68), with overlay renders for QC (:227-241, 291-358). Host numpy,
no OpenCV: masks resize by cv2 INTER_NEAREST's rule
(`geometry.remove_letterbox`), files go through utils/image_io, and an
original image is read for the run's device (a JPEG on a card through
nvJPEG).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.postprocess.clean import find_image
from cartseg_tpu_torch.utils import image_io


def unpad_mask_to_original(mask: np.ndarray, orig_w: int, orig_h: int,
                           side_padding_ratio: float = 0.1) -> np.ndarray:
    return G.remove_letterbox(mask, orig_w, orig_h, side_padding_ratio)


def make_overlay(rgb: np.ndarray, mask01: np.ndarray, alpha: float = 0.45,
                 color=(255, 0, 0)) -> np.ndarray:
    """Blend a mask tint over the image (remove_padding_from_masks.py:
    227-241)."""
    out = rgb.astype(np.float32).copy()
    m = mask01 > 0
    tint = np.asarray(color, np.float32)
    out[m] = out[m] * (1 - alpha) + tint * alpha
    return out.astype(np.uint8)


def unpad_tree(masks_root: Path, images_root: Path, out_root: Path,
               side_padding_ratio: float = 0.1,
               overlays_root: Optional[Path] = None,
               skip_existing: bool = True, device="cuda", log=print) -> int:
    """For every mask, find the original image at the same relative
    path, undo the letterbox and save the mask at the image's size (and
    an RGB overlay PNG under overlays_root)."""
    device = resolve_device(device)
    masks_root, images_root = Path(masks_root), Path(images_root)
    out_root = Path(out_root)
    n = 0
    for mp in sorted(masks_root.rglob("*.png")):
        rel = mp.relative_to(masks_root)
        out = out_root / rel
        if skip_existing and out.exists():
            continue
        img_path = find_image(images_root, rel)
        if img_path is None:
            continue
        img = image_io.read_rgb(img_path, device)
        mask = image_io.read_gray(mp)
        if img is None or mask is None:
            continue
        oh, ow = img.shape[:2]
        rec = unpad_mask_to_original(mask, ow, oh, side_padding_ratio)
        out.parent.mkdir(parents=True, exist_ok=True)
        image_io.write_png(out, rec)
        if overlays_root is not None:
            op = Path(overlays_root) / rel
            op.parent.mkdir(parents=True, exist_ok=True)
            image_io.write_png(op, make_overlay(img, rec > 127))
        n += 1
    log(f"unpadded {n} masks -> {out_root}")
    return n
