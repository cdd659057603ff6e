"""Mask cleaners (counterpart of cartseg_tpu/postprocess/clean.py): the
reference's cv2 loops on [..., H, W] bool tensors, on either device —

  * clean_mask                   — flood-fill hole filling + keep the
                                   largest component (clean_masks.py:12-32)
  * clean_mask_largest_component — the largest component only
                                   (remove_blops.py:14-33)
  * post_clean                   — open(3) -> largest CC -> close(7) ->
                                   fill holes <= 0.4 % of the area
                                   (clean_complete.py:93-103)
  * clean_tree                   — the whole clean_complete pipeline over
                                   a mask tree, cutting mask content
                                   outside the letterbox content box
                                   (:35-65), with skip-existing resume

Masks are read and written through utils/image_io (no OpenCV needed);
the `complete` mode reads each original image for its size only, for
the tree's device (a JPEG on a card through nvJPEG, EXIF orientation
applied as cv2.imread applies it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.ops.connected_components import keep_largest_component
from cartseg_tpu_torch.ops.morphology import (fill_holes_from_border,
                                              fill_small_holes, morph_close,
                                              morph_open)
from cartseg_tpu_torch.utils import image_io

# the image an original mask belongs to, by extension in this order
IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def clean_mask(mask01: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> bool: fill all holes, keep the largest component."""
    return keep_largest_component(fill_holes_from_border(mask01))


def clean_mask_largest_component(mask01: torch.Tensor) -> torch.Tensor:
    return keep_largest_component(mask01)


def post_clean(mask01: torch.Tensor, open_ks: int = 3, close_ks: int = 7,
               hole_frac: float = 0.004) -> torch.Tensor:
    """open -> largest CC -> close -> fill small holes."""
    m = mask01.to(torch.bool)
    if open_ks > 1:
        m = morph_open(m, open_ks)
    m = keep_largest_component(m)
    if close_ks > 1:
        m = morph_close(m, close_ks)
    return fill_small_holes(m, hole_frac)


@dataclasses.dataclass
class CleanConfig:
    masks_root: str = ""
    images_root: Optional[str] = None  # needed for the padding cut
    out_root: Optional[str] = None     # None -> in place
    mode: str = "complete"  # complete | holes_largest | largest_only
    side_padding_ratio: float = 0.1
    open_ks: int = 3
    close_ks: int = 7
    hole_frac: float = 0.004
    skip_existing: bool = False
    device: str = "cuda"


def find_image(images_root: Path, rel: Path) -> Optional[Path]:
    """The original image at a mask's relative path, by IMAGE_EXTS."""
    for ext in IMAGE_EXTS:
        cand = (images_root / rel).with_suffix(ext)
        if cand.exists():
            return cand
    return None


def clean_tree(cfg: CleanConfig, log=print) -> int:
    """Clean every mask under masks_root on cfg.device; returns the count
    written. mode 'complete' reproduces clean_complete.py:134-158 (cut
    the padding by the original image's size, then post_clean)."""
    device = resolve_device(cfg.device)
    masks_root = Path(cfg.masks_root)
    out_root = Path(cfg.out_root) if cfg.out_root else masks_root
    images_root = Path(cfg.images_root) if cfg.images_root else None
    n = 0
    for mp in sorted(masks_root.rglob("*.png")):
        rel = mp.relative_to(masks_root)
        out = out_root / rel
        if cfg.skip_existing and cfg.out_root and out.exists():
            continue
        m = image_io.read_gray(mp)
        if m is None:
            continue
        m255 = (m > 127).astype(np.uint8) * 255

        if cfg.mode == "complete" and images_root is not None:
            img_path = find_image(images_root, rel)
            img = None if img_path is None else \
                image_io.read_rgb(img_path, device)
            if img is not None:
                oh, ow = img.shape[:2]
                m255 = G.cut_mask_padding(m255, ow, oh,
                                          cfg.side_padding_ratio)

        x = torch.from_numpy(m255 > 127).to(device)
        if cfg.mode == "largest_only":
            cleaned = clean_mask_largest_component(x)
        elif cfg.mode == "holes_largest":
            cleaned = clean_mask(x)
        else:
            cleaned = post_clean(x, cfg.open_ks, cfg.close_ks, cfg.hole_frac)
        out.parent.mkdir(parents=True, exist_ok=True)
        image_io.write_png(out, cleaned.cpu().numpy().astype(np.uint8) * 255)
        n += 1
    log(f"cleaned {n} masks -> {out_root}")
    return n
