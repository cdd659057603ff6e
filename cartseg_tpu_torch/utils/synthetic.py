"""Seeded synthetic inputs: masks for the CC checks, a PNG image tree
for the pseudo-label workload and a PNG image+mask tree for training
(the counterparts of cartseg_tpu/data/dataset.py:make_synthetic_tree,
written as PNG through utils/image_io so they need no OpenCV)."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from cartseg_tpu_torch.utils.image_io import write_png


def ring_cuts_mask(n: int) -> np.ndarray:
    """Concentric square rings, each cut once (tests/test_edt_ops.py:
    195-220): many U-shaped components with long geodesics."""
    m = np.zeros((n, n), bool)
    top, bot, left, right = 0, n - 1, 0, n - 1
    while top <= bot and left <= right:
        m[top, left:right + 1] = True
        m[top:bot + 1, right] = True
        m[bot, left:right + 1] = True
        m[top:bot + 1, left] = True
        top += 2
        bot -= 2
        left += 2
        right -= 2
    for i, row in enumerate(range(2, n, 2)):
        m[row, 0 if i % 2 == 0 else n - 1] = False
    return m


def spiral_mask(n: int) -> np.ndarray:
    """ONE square spiral arm with a 1-px gap between turns, from (0, 0)
    inwards: a single component with ~2n turns and a geodesic of about
    n*n/2 pixels, the worst case for scan-based min propagation."""
    m = np.zeros((n, n), bool)
    y = x = 0
    m[0, 0] = True
    steps = [n - 1, n - 1, n - 1]
    k = n - 3
    while k > 0:
        steps += [k, k]
        k -= 2
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    for i, s in enumerate(steps):
        dy, dx = dirs[i % 4]
        for _ in range(s):
            y += dy
            x += dx
            m[y, x] = True
    return m


def blob_masks(rng: np.random.Generator, shape: Tuple[int, int, int],
               n: int = 5) -> np.ndarray:
    """[B,H,W] bool: n random discs per image."""
    B, H, W = shape
    yy, xx = np.ogrid[:H, :W]
    m = np.zeros(shape, bool)
    for b in range(B):
        for _ in range(n):
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            rad = rng.integers(2, max(3, min(H, W) // 5))
            m[b] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    return m


def frame(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    """HxWx3 uint8 RGB: a textured gradient background with a few
    blurred-edge blobs (the contrast the Canny gate looks for)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 90 + 40 * (xx / w) + 25 * np.sin(yy / 9.0)
    img = np.repeat(img[..., None], 3, -1)
    img += rng.normal(0, 6.0, (h, w, 3)).astype(np.float32)
    for _ in range(int(rng.integers(1, 4))):
        cy, cx = rng.integers(h // 5, 4 * h // 5), rng.integers(w // 5,
                                                                 4 * w // 5)
        r = float(rng.integers(min(h, w) // 10, min(h, w) // 4))
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        alpha = np.clip((r - d) / 2.0 + 0.5, 0.0, 1.0)[..., None]
        color = rng.integers(0, 255, 3).astype(np.float32)
        img = img * (1 - 0.7 * alpha) + color * 0.7 * alpha
    return np.clip(img, 0, 255).astype(np.uint8)


def make_png_tree(root, n_sessions: int, per_session: int,
                  hw: Tuple[int, int], seed: int = 0) -> Path:
    """Write images_root/session_XXX/img_YYY.png; returns images_root."""
    rng = np.random.default_rng(seed)
    images_root = Path(root) / "images"
    for s in range(n_sessions):
        d = images_root / f"session_{s:03d}"
        d.mkdir(parents=True, exist_ok=True)
        for k in range(per_session):
            write_png(d / f"img_{k:03d}.png", frame(rng, hw))
    return images_root


def make_png_pair_tree(root, n_sessions: int, per_session: int,
                       hw: Tuple[int, int], seed: int = 0
                       ) -> Tuple[Path, Path]:
    """The training tree: images_root/session_XXX/img_YYY.png frames of
    `hw` with blobs, and masks_root/session_XXX/img_YYY.png of the same
    blobs in LETTERBOXED space (as the reference's masks were made and
    the JAX make_synthetic_tree writes them). Returns (images_root,
    masks_root)."""
    from cartseg_tpu_torch.geometry import letterbox_side_pad

    rng = np.random.default_rng(seed)
    images_root, masks_root = Path(root) / "images", Path(root) / "masks"
    h, w = hw
    yy, xx = np.ogrid[:h, :w]
    for s in range(n_sessions):
        sess = f"session_{s:03d}"
        (images_root / sess).mkdir(parents=True, exist_ok=True)
        (masks_root / sess).mkdir(parents=True, exist_ok=True)
        for k in range(per_session):
            img = frame(rng, hw)
            blob = np.zeros((h, w), bool)
            for _ in range(int(rng.integers(1, 3))):
                cy = rng.integers(h // 4, 3 * h // 4)
                cx = rng.integers(w // 4, 3 * w // 4)
                r = int(rng.integers(max(2, min(h, w) // 10),
                                     max(3, min(h, w) // 4)))
                blob |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[blob] = (img[blob] * 0.3 + np.array([200, 60, 60]) * 0.7
                         ).astype(np.uint8)
            write_png(images_root / sess / f"img_{k:03d}.png", img)
            write_png(masks_root / sess / f"img_{k:03d}.png",
                      letterbox_side_pad((blob * 255).astype(np.uint8)))
    return images_root, masks_root
