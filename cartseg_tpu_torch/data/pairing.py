"""File-system pairing and leakage-safe splits (counterpart of
cartseg_tpu/data/pairing.py, which holds no JAX; held bit-equal by
tests/test_torch_train.py) — the host-side dataset plumbing every
reference script re-implements:

  * gather_pairs            — session-dir layout (train_bce_dice.py:122-134)
  * gather_pairs_multiroot  — multi-root rglob + single mask tree
                              (src/train_pseudo.py:172-193)
  * gather_pairs_mirror     — mirrored rel-path trees with any mask ext
                              (src/finetune_for_224.py:113-127)
  * derive_session_key      — store_*/session_* heuristic
                              (src/train_pseudo.py:130-153)
  * session_split            — deterministic 80/20 by sorted session
                              (train_bce_dice.py:240-247)
  * random_split             — seeded permutation split
                              (src/finetune_for_224.py:163-168)

Determinism matters beyond reproducibility: every host in a multi-chip
job computes the same split independently, so no coordination traffic
is needed (SURVEY.md section 5, distributed plan).
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
MASK_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


@dataclasses.dataclass(frozen=True)
class Pair:
    image: Path
    mask: Optional[Path]
    session: str

    def astuple(self):
        return (self.image, self.mask, self.session)


def derive_session_key(rel_path: Path) -> str:
    """Stable session key from a relative path: prefer
    store_*/session_* components, else first two levels."""
    parts = list(Path(rel_path).parts)
    for i, comp in enumerate(parts):
        if comp.startswith("session_"):
            prev = parts[i - 1] if i - 1 >= 0 else ""
            if prev.startswith("store_"):
                return f"{prev}/{comp}"
            return comp
    if len(parts) >= 2:
        return "/".join(parts[:2])
    if len(parts) == 1:
        return parts[0]
    return "unknown_session"


def gather_pairs(images_root: Path, masks_root: Path,
                 img_glob: str = "*.jpeg") -> List[Pair]:
    """Session-directory layout: images_root/<session>/*.jpeg paired
    with masks_root/<session>/<stem>.png."""
    images_root, masks_root = Path(images_root), Path(masks_root)
    pairs: List[Pair] = []
    for session_dir in sorted(p for p in images_root.iterdir() if p.is_dir()):
        mask_session = masks_root / session_dir.name
        for img in sorted(session_dir.glob(img_glob)):
            mask = mask_session / (img.stem + ".png")
            if mask.exists():
                pairs.append(Pair(img, mask, session_dir.name))
    return pairs


def gather_pairs_multiroot(image_roots: Sequence[Path], masks_root: Path,
                           seed: Optional[int] = None) -> List[Pair]:
    """Multiple image roots, one mask tree with identical relative
    structure (mask ext forced to .png); session key derived from the
    relative path. Optional deterministic shuffle (the reference
    shuffles in _gather_pairs with its global seed,
    train_pseudo.py:191-192)."""
    masks_root = Path(masks_root)
    pairs: List[Pair] = []
    for root in image_roots:
        root = Path(root)
        if not root.exists():
            continue
        for img in sorted(root.rglob("*")):
            if img.suffix.lower() not in IMG_EXTS:
                continue
            rel = img.relative_to(root)
            mask = (masks_root / rel).with_suffix(".png")
            if mask.exists():
                pairs.append(Pair(img, mask, derive_session_key(rel)))
    if seed is not None:
        random.Random(seed).shuffle(pairs)
    return pairs


def gather_pairs_mirror(img_root: Path, mask_root: Path) -> List[Pair]:
    """Mirrored trees: same rel path under both roots, mask may have
    any extension (first hit in MASK_EXTS order wins)."""
    img_root, mask_root = Path(img_root), Path(mask_root)
    pairs: List[Pair] = []
    for img in sorted(img_root.rglob("*")):
        if img.suffix.lower() not in IMG_EXTS:
            continue
        rel = img.relative_to(img_root)
        for ext in MASK_EXTS:
            mp = (mask_root / rel).with_suffix(ext)
            if mp.exists():
                pairs.append(Pair(img, mp, derive_session_key(rel)))
                break
    return pairs


def session_split(pairs: Sequence[Pair], val_frac: float = 0.2
                  ) -> Tuple[List[int], List[int]]:
    """Deterministic split by sorted unique session: the FIRST n_val
    sessions go to val (train_bce_dice.py:240-247). Returns
    (train_idx, val_idx)."""
    sessions = sorted({p.session for p in pairs})
    n_val = max(1, int(val_frac * len(sessions)))
    val_sessions = set(sessions[:n_val])
    train_idx, val_idx = [], []
    for i, p in enumerate(pairs):
        (val_idx if p.session in val_sessions else train_idx).append(i)
    return train_idx, val_idx


def session_split_seeded(pairs: Sequence[Pair], val_frac: float = 0.2,
                         seed: int = 1337) -> Tuple[List[int], List[int]]:
    """Session split with a seeded shuffle of the session list (the
    train_pseudo variant, which seeds globals at :58-64)."""
    sessions = sorted({p.session for p in pairs})
    random.Random(seed).shuffle(sessions)
    n_val = max(1, int(val_frac * len(sessions)))
    val_sessions = set(sessions[:n_val])
    train_idx, val_idx = [], []
    for i, p in enumerate(pairs):
        (val_idx if p.session in val_sessions else train_idx).append(i)
    return train_idx, val_idx


def random_split(n: int, val_frac: float, seed: int = 42
                 ) -> Tuple[List[int], List[int]]:
    """Seeded permutation split over n items — numpy RandomState
    semantics to match split_hard_for_val
    (finetune_for_224.py:163-168)."""
    import numpy as np

    n_val = max(1, int(val_frac * n))
    idx = np.random.RandomState(seed).permutation(n)
    val_idx = set(idx[:n_val].tolist())
    train_idx = [i for i in range(n) if i not in val_idx]
    return train_idx, sorted(val_idx)


def shard_for_host(indices: Sequence[int], host_index: int,
                   host_count: int) -> List[int]:
    """Per-host shard of a deterministic index list for multi-host DP
    (every host computes the same split, then takes its stride slice)."""
    return list(indices[host_index::host_count])
