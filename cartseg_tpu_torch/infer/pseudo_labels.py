"""Pseudo-label generation (counterpart of
cartseg_tpu/infer/pseudo_labels.py): the batched
create_pseudo_labels_gpu.py path with the QC gates and artifacts of
create_pseudo_labels.py —

  * weighted ensemble sigma-mean + flip TTA on the device
  * QC gates (:146-151, 191-197): fg_area in [0.005, 0.60],
    fg_conf >= 0.65, mean_entropy <= 0.35, TTA IoU >= 0.75,
    edge-hit >= 0.10 (Canny by default; the Sobel gate by edge_method)
  * connected-component cleanup with min_area = 0.1% of the frame
  * accepted/uncertain routing, hard-mask PNG + fp16 soft-prob npz +
    overlay PNG + QC CSV (:243-260)
  * per-bucket cap (default 50) and global cap (:264-287)

Not carried over from the JAX version: `use_mesh` (batch sharding over
a device mesh; data parallelism is a later slice).
"""

from __future__ import annotations

import csv
import dataclasses
import random
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.infer.engine import (EnsembleMember,
                                            pseudo_label_program)
from cartseg_tpu_torch.utils import image_io

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
QC_HEADER = ["image", "fg_area", "fg_conf", "mean_entropy", "tta_iou",
             "edge_hit", "accepted", "threshold"]


@dataclasses.dataclass
class QCThresholds:
    min_fg_area: float = 0.005
    max_fg_area: float = 0.60
    min_fg_conf: float = 0.65
    max_mean_entropy: float = 0.35
    min_tta_iou: float = 0.75
    min_edge_hit: float = 0.10


def should_accept(fg_area, fg_conf, mean_entropy, tta_iou, edge_hit,
                  t: QCThresholds = QCThresholds()) -> bool:
    """create_pseudo_labels.py:191-197, verbatim logic."""
    if fg_area < t.min_fg_area or fg_area > t.max_fg_area:
        return False
    if fg_conf < t.min_fg_conf:
        return False
    if mean_entropy > t.max_mean_entropy:
        return False
    if tta_iou < t.min_tta_iou:
        return False
    if edge_hit < t.min_edge_hit:
        return False
    return True


@dataclasses.dataclass
class PseudoLabelConfig:
    images_root: str = ""
    out_dir: str = "pseudo_masks"
    overlay_dir: Optional[str] = None
    img_size: int = 512
    side_padding_ratio: float = 0.1
    imagenet_norm: bool = True
    threshold: Optional[float] = None   # None -> first member's sidecar
    batch_size: int = 64
    qc: QCThresholds = dataclasses.field(default_factory=QCThresholds)
    min_area_frac: float = 0.001
    max_masks: int = 100_000
    max_per_bucket: int = 50
    save_probs: bool = True
    save_overlays: bool = True
    shuffle_seed: int = 0
    # QC edge gate: 'canny' reproduces cv2.Canny(50,150)
    # (create_pseudo_labels.py:178-189); 'sobel' uses edge_threshold
    edge_method: str = "canny"
    canny_low: float = 50.0
    canny_high: float = 150.0
    edge_threshold: float = 120.0


def _overlay(rgb_u8: np.ndarray, pred01: np.ndarray) -> np.ndarray:
    """Red boundary overlay (create_pseudo_labels.py:251-253)."""
    import cv2

    out = rgb_u8.copy()
    cnts, _ = cv2.findContours(pred01.astype(np.uint8),
                               cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    cv2.drawContours(out, cnts, -1, (255, 0, 0), 2)
    return out


def load_frame(path, size: int, side_padding_ratio: float,
               device) -> Optional[np.ndarray]:
    """One frame of the host loop: read for `device` (a JPEG on a card
    through nvJPEG), letterboxed and resized to size x size by the native
    loader; None for a file cv2.imread would not read."""
    rgb = image_io.read_rgb(path, device)
    if rgb is None:
        return None
    return G.letterbox_resize(rgb, size, side_padding_ratio)


def generate_pseudo_labels(members: Sequence[EnsembleMember],
                           cfg: PseudoLabelConfig, device="cuda",
                           log=print) -> dict:
    """Run the ensemble over every image under cfg.images_root on
    `device` (the members' device) and write masks, probs, overlays and
    qc_scores.csv. Frames are read for `device` (JPEG through nvJPEG on
    a card) and letterboxed and resized by the native loader
    (`geometry.letterbox_resize`). Returns {"accepted", "buckets",
    "threshold", "read_s", "wall_s"}: the host seconds spent reading and
    letterboxing frames, and the loop's wall seconds."""
    device = torch.device(device)
    root = Path(cfg.images_root)
    out_dir = Path(cfg.out_dir)
    uncertain_dir = out_dir / "uncertain"
    out_dir.mkdir(parents=True, exist_ok=True)
    uncertain_dir.mkdir(parents=True, exist_ok=True)
    overlay_dir = Path(cfg.overlay_dir) if cfg.overlay_dir else None
    if overlay_dir and cfg.save_overlays and not image_io.have_cv2():
        raise RuntimeError(
            "overlays (--overlay_dir) draw cv2 contours and need OpenCV "
            "(cv2), which is not installed; leave --overlay_dir unset")
    if overlay_dir:
        overlay_dir.mkdir(parents=True, exist_ok=True)

    threshold = cfg.threshold if cfg.threshold is not None \
        else members[0].threshold
    mean = IMAGENET_MEAN if cfg.imagenet_norm else (0, 0, 0)
    std = IMAGENET_STD if cfg.imagenet_norm else (1, 1, 1)
    min_area = int(cfg.img_size * cfg.img_size * cfg.min_area_frac)
    program = pseudo_label_program(
        members, mean, std, min_area, edge_threshold=cfg.edge_threshold,
        edge_method=cfg.edge_method, canny_low=cfg.canny_low,
        canny_high=cfg.canny_high)

    paths = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in IMG_EXTS)
    random.Random(cfg.shuffle_seed).shuffle(paths)
    log(f"Found {len(paths)} images, generating up to {cfg.max_masks}.")

    qc_csv = out_dir / "qc_scores.csv"
    if not qc_csv.exists():
        with open(qc_csv, "w", newline="") as f:
            csv.writer(f).writerow(QC_HEADER)

    counter = 0
    bucket_counts: dict = {}
    S = cfg.img_size
    # host seconds spent reading (decoding) and letterboxing frames
    read_s = [0.0]
    t_start = time.perf_counter()

    def batches():
        batch, metas = [], []
        for p in paths:
            bucket = p.parent.name
            if bucket_counts.get(bucket, 0) >= cfg.max_per_bucket:
                continue
            t0 = time.perf_counter()
            img = load_frame(p, S, cfg.side_padding_ratio, device)
            read_s[0] += time.perf_counter() - t0
            if img is None:
                continue
            batch.append(img)
            metas.append((p, bucket))
            if len(batch) == cfg.batch_size:
                yield np.stack(batch), metas
                batch, metas = [], []
        if batch:
            # pad the tail to the full batch shape; the save loop walks
            # metas, so padded rows are never written
            while len(batch) < cfg.batch_size:
                batch.append(np.zeros_like(batch[0]))
            yield np.stack(batch), metas

    for imgs, metas in batches():
        if counter >= cfg.max_masks:
            break
        x = torch.from_numpy(imgs).to(device)
        pred, probs, stats = program(x, float(threshold))
        pred_np = pred.cpu().numpy().astype(np.uint8)
        probs_np = probs.cpu().numpy()
        stats_np = {k: v.cpu().numpy() for k, v in stats.items()}

        for i, (p, bucket) in enumerate(metas):
            if bucket_counts.get(bucket, 0) >= cfg.max_per_bucket:
                # a batch may hold more same-bucket images than the cap
                # admits (create_pseudo_labels_gpu.py:306-307)
                continue
            rel = p.relative_to(root)
            acc = should_accept(
                stats_np["fg_area"][i], stats_np["fg_conf"][i],
                stats_np["mean_entropy"][i], stats_np["tta_iou"][i],
                stats_np["edge_hit"][i], cfg.qc)
            base = (out_dir if acc else uncertain_dir) / rel.parent
            base.mkdir(parents=True, exist_ok=True)
            image_io.write_png(base / f"{p.stem}.png", pred_np[i] * 255)
            if cfg.save_probs:
                np.savez_compressed(base / f"{p.stem}_prob.npz",
                                    prob=probs_np[i].astype(np.float16))
            if cfg.save_overlays and overlay_dir is not None:
                image_io.write_png(
                    overlay_dir / f"{p.stem}_overlay_512.png",
                    _overlay(imgs[i], pred_np[i]))
            with open(qc_csv, "a", newline="") as f:
                csv.writer(f).writerow(
                    [str(rel), f"{stats_np['fg_area'][i]:.4f}",
                     f"{stats_np['fg_conf'][i]:.2f}",
                     f"{stats_np['mean_entropy'][i]:.3f}",
                     f"{stats_np['tta_iou'][i]:.2f}",
                     f"{stats_np['edge_hit'][i]:.2f}",
                     int(acc), f"{threshold:.2f}"])
            if acc:
                counter += 1
                bucket_counts[bucket] = bucket_counts.get(bucket, 0) + 1
                if counter >= cfg.max_masks:
                    break

    wall = time.perf_counter() - t_start
    log(f"Read and letterboxed frames in {read_s[0]:.2f} s of the "
        f"{wall:.2f} s loop.")
    return {"accepted": counter, "buckets": bucket_counts,
            "threshold": threshold, "read_s": read_s[0], "wall_s": wall}
