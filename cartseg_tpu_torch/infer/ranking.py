"""Soft-prob ranking (counterpart of cartseg_tpu/infer/ranking.py;
reference get_best_pseudo_masks.py), host only: score each saved
*_prob.npz by 0.7*fg_conf - 0.5*mean_entropy + 0.3*area_penalty
(:30-38), write ranking.csv, and copy the top-K masks and probs keeping
the store/session tree (:53-119). The CSV is written with `csv` (no
pandas) in the JAX workload's columns and number format; rows rank by
descending score, ties in the order the pairs were found (sorted
paths; Python's stable sort).
"""

from __future__ import annotations

import csv
import dataclasses
import shutil
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RankingConfig:
    src_root: str = ""
    dst_root: str = "best_pseudo"
    threshold: float = 0.5
    top_k: int = 1300
    min_fg_area: float = 0.005
    max_fg_area: float = 0.60


def entropy_map(p, eps: float = 1e-6):
    p = np.clip(p.astype(np.float64), eps, 1.0 - eps)
    return -(p * np.log(p) + (1.0 - p) * np.log(1.0 - p))


def compute_metrics(prob: np.ndarray, threshold: float
                    ) -> Tuple[float, float, float]:
    fg_area = float((prob >= threshold).mean())
    fg_conf = float(np.median(np.abs(prob - 0.5) * 2.0))
    mean_ent = float(entropy_map(prob).mean())
    return fg_area, fg_conf, mean_ent


def score_sample(fg_area: float, fg_conf: float, mean_ent: float,
                 min_fg: float = 0.005, max_fg: float = 0.60) -> float:
    area_penalty = 0.0
    if fg_area < min_fg:
        area_penalty = -min(1.0, (min_fg - fg_area) / min_fg)
    elif fg_area > max_fg:
        area_penalty = -min(1.0, (fg_area - max_fg) / (1.0 - max_fg))
    return float(0.7 * fg_conf - 0.5 * mean_ent + 0.3 * area_penalty)


def find_pairs(src_root: Path) -> Iterable[Tuple[Path, Path, Path]]:
    for prob_path in sorted(src_root.rglob("*_prob.npz")):
        stem = prob_path.stem
        if not stem.endswith("_prob"):
            continue
        mask_path = prob_path.with_name(stem[:-5] + ".png")
        if not mask_path.exists():
            continue
        yield prob_path, mask_path, mask_path.parent.relative_to(src_root)


def rank_pseudo_masks(cfg: RankingConfig, log=print) -> Optional[list]:
    """Rank every prob/mask pair under cfg.src_root; write
    dst_root/ranking.csv, copy the top_k; return the rows (dicts), best
    first."""
    src = Path(cfg.src_root)
    dst = Path(cfg.dst_root)
    rows = []
    for prob_path, mask_path, rel_dir in find_pairs(src):
        try:
            prob = np.load(prob_path)["prob"].astype(np.float32)
        except Exception:
            continue
        fg_area, fg_conf, mean_ent = compute_metrics(prob, cfg.threshold)
        rows.append({
            "prob": str(prob_path), "mask": str(mask_path),
            "rel_dir": str(rel_dir), "fg_area": fg_area,
            "fg_conf": fg_conf, "mean_entropy": mean_ent,
            "score": score_sample(fg_area, fg_conf, mean_ent,
                                  cfg.min_fg_area, cfg.max_fg_area),
        })
    if not rows:
        log("no prob/mask pairs found")
        return None
    rows.sort(key=lambda r: -r["score"])
    dst.mkdir(parents=True, exist_ok=True)
    with open(dst / "ranking.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    for row in rows[:cfg.top_k]:
        out = dst / row["rel_dir"]
        out.mkdir(parents=True, exist_ok=True)
        shutil.copy2(row["mask"], out / Path(row["mask"]).name)
        shutil.copy2(row["prob"], out / Path(row["prob"]).name)
    log(f"Copied top {min(cfg.top_k, len(rows))} of {len(rows)} to {dst}")
    return rows
