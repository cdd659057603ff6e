"""Active-learning hard-case mining (counterpart of
cartseg_tpu/infer/mining.py; reference mine_hard_cases.py).

Per image, batched on the device (the reference loops at bs 1, :168):
mean entropy (:71-73), the share of pixels near the threshold (:75-76),
the flip-TTA variance (:78-81), the component count (:93-95), the hole
fraction (:97-113), perimeter over area (:86-91) and the composite
(:189-190):

  0.35*ent + 0.25*near + 0.20*ttaVar + 0.10*holes
  + 0.10*min(P/A / 0.2, 1) + 0.05*min(components, 3)

The perimeter is the boundary-pixel count (`mask_boundary`) instead of
cv2 arcLength, as in the JAX package. Both CC passes run on the whole
batch: 8-connectivity for the components, 4-connectivity on the
background for the holes (cv2.floodFill's spread). hard_candidates.csv
is written with `csv` (no pandas), ranked by descending composite with
ties kept in the order the frames were read (Python's stable sort;
pandas' default quicksort leaves a tie's order unspecified).
"""

from __future__ import annotations

import csv
import dataclasses
import random
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cartseg_tpu_torch.device import set_fp32_policy
from cartseg_tpu_torch.infer.engine import (EnsembleMember, _ensemble_forward,
                                            _tta, ensemble_probs_fn,
                                            entropy_map)
from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                   IMAGENET_STD, IMG_EXTS,
                                                   load_frame)
from cartseg_tpu_torch.ops.connected_components import count_components
from cartseg_tpu_torch.ops.edges import mask_boundary
from cartseg_tpu_torch.ops.morphology import fill_holes_from_border
from cartseg_tpu_torch.utils import image_io


@dataclasses.dataclass
class MiningConfig:
    images_root: str = ""
    out_dir: str = "hard_mining"
    img_size: int = 512
    side_padding_ratio: float = 0.1
    imagenet_norm: bool = True
    threshold: float = 0.5
    delta_near: float = 0.05
    batch_size: int = 16
    sample_size: Optional[int] = 5000
    seed: int = 1337
    save_previews: bool = False
    preview_top_k: int = 50


def metrics_body(threshold: float, delta: float) -> Callable:
    """fn(probs, probs_flip) [B,H,W] -> dict of per-image metrics [B]."""

    def metrics(probs: torch.Tensor, probs_flip: torch.Tensor) -> dict:
        p_mean = (probs + probs_flip) / 2.0
        ent = entropy_map(p_mean, 1e-7).mean((1, 2))
        near = ((p_mean - 0.5).abs() < delta).to(torch.float32).mean((1, 2))
        # population variance, as jnp.var (ddof 0)
        var = torch.stack([probs, probs_flip]).var(0, correction=0).mean(
            (1, 2))
        m01 = p_mean > threshold
        comps = count_components(m01)
        holes = fill_holes_from_border(m01) & ~m01
        area = m01.sum((1, 2))
        hole_frac = torch.where(
            area > 0, holes.sum((1, 2)) / area.clamp(min=1), 0.0)
        per = mask_boundary(m01).sum((1, 2))
        per_area = torch.where(
            area > 0, per / (area.to(torch.float32) + 1e-7), 0.0)
        score = (0.35 * ent + 0.25 * near + 0.20 * var
                 + 0.10 * hole_frac
                 + 0.10 * torch.clamp(per_area / 0.2, max=1.0)
                 + 0.05 * torch.clamp(comps.to(torch.float32), max=3.0))
        return {"entropy_mean": ent, "frac_near_0p5": near,
                "tta_var_mean": var, "components": comps.to(torch.int32),
                "hole_fraction": hole_frac,
                "perimeter_over_area": per_area, "composite": score}

    return metrics


def mining_program(members: Sequence[EnsembleMember], mean, std,
                   threshold: float, delta_near: float) -> Callable:
    """The per-batch mining computation on the members' device:
    fn(images_u8 [B,H,W,3]) -> dict of per-image metrics [B] (the
    ensemble with flip TTA, then `metrics_body`). Like
    `pseudo_label_program`, it keeps float32 outside the model in full
    float32 (`set_fp32_policy`)."""
    set_fp32_policy()
    forward_tta = _tta(_ensemble_forward(members, mean, std))
    body = metrics_body(threshold, delta_near)

    @torch.inference_mode()
    def program(images_u8: torch.Tensor) -> dict:
        return body(*forward_tta(images_u8))

    return program


def mine_hard_cases(members: Sequence[EnsembleMember], cfg: MiningConfig,
                    device="cuda", log=print) -> Optional[list]:
    """Score every image under cfg.images_root (or a seeded sample of
    cfg.sample_size of them) on `device`, the members' device; write
    out_dir/hard_candidates.csv and return its rows (dicts), best
    first. Frames are read as the pseudo-labeller reads them
    (`load_frame`: nvJPEG on a card, the native letterbox)."""
    if cfg.save_previews and not image_io.have_cv2():
        raise RuntimeError(
            "mining previews (save_previews) draw cv2's colormap and "
            "contours and need OpenCV (cv2), which is not installed; "
            "leave save_previews off")
    device = torch.device(device)
    root = Path(cfg.images_root)
    out_dir = Path(cfg.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    imgs = sorted(p for p in root.rglob("*") if p.suffix.lower() in IMG_EXTS)
    log(f"Found {len(imgs)} images total.")
    if cfg.sample_size is not None and len(imgs) > cfg.sample_size:
        imgs = random.Random(cfg.seed).sample(imgs, cfg.sample_size)
        sdir = out_dir / "sampling"
        sdir.mkdir(parents=True, exist_ok=True)
        with open(sdir / f"sampled_images_seed{cfg.seed}_n{len(imgs)}.txt",
                  "w") as f:
            f.writelines(str(p) + "\n" for p in imgs)

    mean = IMAGENET_MEAN if cfg.imagenet_norm else (0, 0, 0)
    std = IMAGENET_STD if cfg.imagenet_norm else (1, 1, 1)
    program = mining_program(members, mean, std, cfg.threshold,
                             cfg.delta_near)
    rows = []
    batch, metas = [], []

    def flush():
        out = program(torch.from_numpy(np.stack(batch)).to(device))
        # the metrics' columns in sorted order, as the JAX workload's CSV
        # has them (its jitted program returns a key-sorted dict)
        out = {k: out[k].cpu().numpy() for k in sorted(out)}
        for i, p in enumerate(metas):
            rows.append({"path": str(p),
                         **{k: float(out[k][i]) for k in out}})
        batch.clear()
        metas.clear()

    for p in imgs:
        img = load_frame(p, cfg.img_size, cfg.side_padding_ratio, device)
        if img is None:
            continue
        batch.append(img)
        metas.append(p)
        if len(batch) == cfg.batch_size:
            flush()
    if batch:
        flush()

    if not rows:
        log("No rows to save. Check image paths.")
        return None
    rows.sort(key=lambda r: -r["composite"])
    csv_path = out_dir / "hard_candidates.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    log(f"Saved {len(rows)} rows to {csv_path}")
    if cfg.save_previews:
        fwd = ensemble_probs_fn(members, mean, std, tta_flip=True)
        _save_previews(rows[:cfg.preview_top_k], fwd, cfg, out_dir, device,
                       log)
    return rows


def _save_previews(rows: list, fwd, cfg: MiningConfig, out_dir: Path,
                   device, log) -> None:
    """Triptych previews of the top-ranked candidates
    (mine_hard_cases.py:215-252): image | prob heatmap | mask contours,
    drawn with cv2's colormap and contours."""
    import cv2

    pdir = out_dir / "previews"
    pdir.mkdir(parents=True, exist_ok=True)
    for rank, row in enumerate(rows):
        img = load_frame(row["path"], cfg.img_size, cfg.side_padding_ratio,
                         device)
        if img is None:
            continue
        probs, probs_flip = fwd(torch.from_numpy(img[None]).to(device))
        p = ((probs + probs_flip) / 2.0)[0].cpu().numpy()
        heat = cv2.applyColorMap((p * 255).astype(np.uint8),
                                 cv2.COLORMAP_JET)
        m = (p > cfg.threshold).astype(np.uint8)
        overlay = img.copy()
        cnts, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(overlay, cnts, -1, (255, 0, 0), 2)
        panel = np.concatenate(
            [cv2.cvtColor(img, cv2.COLOR_RGB2BGR), heat,
             cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR)], axis=1)
        cv2.imwrite(str(pdir / f"{rank:04d}_{Path(row['path']).stem}.png"),
                    panel)
    log(f"Saved {len(rows)} previews to {pdir}")
