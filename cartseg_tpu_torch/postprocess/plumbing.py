"""Dataset plumbing (counterpart of cartseg_tpu/postprocess/plumbing.py;
reference L8): image <-> mask tree copies, host only.

  * copy_matching_images — for each mask, copy the source image with the
    same stem and relative directory, with a case-insensitive extension
    fallback (get_images.py:27-74)
  * copy_masks — a mask copy that leaves out overlay and prob renders
    (sort_pseudo.py:9-20)
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Sequence

IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".tif", ".tiff")


def _find_image(images_root: Path, rel_dir: Path, stem: str):
    base = images_root / rel_dir
    for ext in IMG_EXTS:
        for cand in (base / f"{stem}{ext}", base / f"{stem}{ext.upper()}"):
            if cand.exists():
                return cand
    if base.exists():
        low = stem.lower()
        for p in base.iterdir():
            if p.stem.lower() == low and p.suffix.lower() in IMG_EXTS:
                return p
    return None


def copy_matching_images(masks_root: Path, images_root: Path,
                         out_root: Path, log=print) -> int:
    masks_root, images_root = Path(masks_root), Path(images_root)
    out_root = Path(out_root)
    n, missing = 0, 0
    for mp in sorted(masks_root.rglob("*.png")):
        rel = mp.relative_to(masks_root)
        img = _find_image(images_root, rel.parent, mp.stem)
        if img is None:
            missing += 1
            continue
        dst = out_root / rel.parent / img.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(img, dst)
        n += 1
    log(f"copied {n} images ({missing} missing) -> {out_root}")
    return n


def copy_masks(src_root: Path, dst_root: Path,
               exclude_suffixes: Sequence[str] = ("_overlay_512.png",
                                                  "_probs_512.png"),
               log=print) -> int:
    src_root, dst_root = Path(src_root), Path(dst_root)
    n = 0
    for p in sorted(src_root.rglob("*.png")):
        if any(p.name.endswith(s) for s in exclude_suffixes):
            continue
        dst = dst_root / p.relative_to(src_root)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(p, dst)
        n += 1
    log(f"copied {n} masks -> {dst_root}")
    return n
