"""Ensemble inference core (counterpart of cartseg_tpu/infer/engine.py).

The reference loads up to 3 checkpoints and averages weighted sigmoids
(create_pseudo_labels.py:87-90, 217-223; batched version
create_pseudo_labels_gpu.py:201-215). `pseudo_label_program` runs the
ensemble forward with flip TTA, the CC cleanup and every QC statistic
on the device for one batch; the host only decodes and encodes images.
`ensemble_probs_fn` is the forward alone (mining's previews);
infer/mining.py builds its program from the same pieces.

On the card the model computes in bf16 (as the JAX workload does,
engine.py:38) and the logits are cast to fp32 before the sigmoid;
float32 convolutions and matmuls outside the model are kept in full
float32 (`device.set_fp32_policy`: cuDNN TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.nn as nn

from cartseg_tpu_torch.device import resolve_device, set_fp32_policy
from cartseg_tpu_torch.models.factory import build_model
from cartseg_tpu_torch.ops.connected_components import (
    remove_small_components)
from cartseg_tpu_torch.ops.cuda.median import median_nonneg_last_axis
from cartseg_tpu_torch.ops.edges import edge_hit_rate


@dataclasses.dataclass
class EnsembleMember:
    model: nn.Module
    weight: float
    threshold: float = 0.5


def prepare_model(model: nn.Module, device, dtype=None) -> nn.Module:
    """Eval model on `device`, in `dtype` (default: bf16 on the card,
    fp32 on the CPU)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return model.to(device=device, dtype=dtype).eval()


def read_threshold_sidecar(pth_path: Path, default: float = 0.5) -> float:
    """`<ckpt>.threshold.json` {"threshold": t} beside a checkpoint
    (create_pseudo_labels.py:37-41; engine.py:62-68)."""
    f = Path(pth_path).with_suffix(".threshold.json")
    if not f.exists():
        return default
    try:
        return float(json.loads(f.read_text())["threshold"])
    except (ValueError, KeyError, TypeError):
        return default


def load_member(pth_path, encoder: str = "efficientnet-b0",
                weight: float = 1.0, device="cuda",
                dtype=None) -> EnsembleMember:
    """Load a reference-naming `.pth` (a bare state dict, or a dict with
    `model_state_dict` as train_bce_dice.py:368-374 saves it) and its
    threshold sidecar."""
    pth_path = Path(pth_path)
    if pth_path.is_dir():
        raise ValueError(
            f"{pth_path} is a directory (a JAX/orbax checkpoint?); the "
            "port loads .pth state dicts — convert JAX variables with "
            "cartseg_tpu_torch/models/convert.py "
            "(jax_variables_to_state_dict) and torch.save the result")
    sd = torch.load(str(pth_path), map_location="cpu", weights_only=True)
    sd = sd.get("model_state_dict", sd)
    model = build_model(encoder)
    model.load_state_dict(sd)
    return EnsembleMember(prepare_model(model, device, dtype), weight,
                          read_threshold_sidecar(pth_path))


def _ensemble_forward(members: Sequence[EnsembleMember], mean, std):
    """Weighted sigma-mean of the members: uint8 [B,H,W,3] -> [B,H,W]
    fp32 probs."""
    ws = torch.tensor([m.weight for m in members], dtype=torch.float64)
    ws = (ws / ws.sum()).tolist()

    def forward(images_u8: torch.Tensor) -> torch.Tensor:
        dev = images_u8.device
        m = torch.tensor(mean, dtype=torch.float32, device=dev)
        s = torch.tensor(std, dtype=torch.float32, device=dev)
        x = ((images_u8.to(torch.float32) / 255.0 - m) / s)
        x = x.permute(0, 3, 1, 2).contiguous()           # NHWC -> NCHW
        probs = None
        for member, w in zip(members, ws):
            dtype = next(member.model.parameters()).dtype
            logits = member.model(x.to(dtype))
            p = float(w) * torch.sigmoid(logits[:, 0].to(torch.float32))
            probs = p if probs is None else probs + p
        return probs

    return forward


def _tta(forward: Callable) -> Callable:
    def forward_tta(images_u8):
        # one ensemble pass at 2B (originals ++ mirrored) instead of two
        B = images_u8.shape[0]
        p = forward(torch.cat([images_u8, images_u8.flip(2)], 0))
        return p[:B], p[B:].flip(-1)

    return forward_tta


def ensemble_probs_fn(members: Sequence[EnsembleMember], mean, std,
                      tta_flip: bool = False) -> Callable:
    """fn(images_u8 [B,H,W,3]) -> probs [B,H,W] fp32, the weighted
    sigma-mean of the members (with tta_flip, (probs, flipped-input
    probs flipped back))."""
    forward = _ensemble_forward(members, mean, std)
    return torch.inference_mode()(_tta(forward) if tta_flip else forward)


def entropy_map(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = p.clamp(eps, 1.0 - eps)
    return -(p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))


def qc_stats_fn(edge_threshold: float = 120.0,
                edge_method: str = "canny",
                canny_low: float = 50.0,
                canny_high: float = 150.0) -> Callable:
    """fn(probs, probs_flip, images_u8, threshold) -> dict of per-image
    QC stats [B] (create_pseudo_labels.py:233-240): fg_area, fg_conf
    (median |p-.5|*2), mean_entropy, tta_iou, edge_hit (the share of
    mask-boundary pixels on an image edge). edge_method 'canny' is the
    reference's Canny(50,150) gate (create_pseudo_labels.py:178-189);
    any other value takes the single-threshold Sobel gate at
    edge_threshold, which launches no reach kernel."""

    def stats(probs, probs_flip, images_u8, threshold):
        B = probs.shape[0]
        pred = probs >= threshold
        fg_area = pred.to(torch.float32).mean((1, 2))
        conf = (probs - 0.5).abs() * 2.0
        fg_conf = median_nonneg_last_axis(conf.reshape(B, -1))
        mean_ent = entropy_map(probs).mean((1, 2))
        pred_f = probs_flip >= threshold
        inter = (pred & pred_f).to(torch.float32).sum((1, 2))
        union = (pred | pred_f).to(torch.float32).sum((1, 2))
        tta_iou = torch.where(union > 0, inter / union.clamp(min=1), 0.0)
        edge_hit = edge_hit_rate(images_u8, pred, edge_threshold,
                                 edge_method, canny_low, canny_high)
        return {"fg_area": fg_area, "fg_conf": fg_conf,
                "mean_entropy": mean_ent, "tta_iou": tta_iou,
                "edge_hit": edge_hit}

    return stats


def pseudo_label_program(members: Sequence[EnsembleMember], mean, std,
                         min_area: int, edge_threshold: float = 120.0,
                         edge_method: str = "canny",
                         canny_low: float = 50.0,
                         canny_high: float = 150.0) -> Callable:
    """The per-batch pseudo-label computation:
    fn(images_u8 [B,H,W,3] on the members' device, threshold) ->
    (pred [B,H,W] bool CC-cleaned, probs [B,H,W] fp32, stats dict).

    fg_area is taken on the CLEANED mask (the reference computes it
    after clean_mask, create_pseudo_labels.py:235); every other stat is
    on the raw thresholded probs, as engine.py:171-209."""
    set_fp32_policy()
    forward_tta = _tta(_ensemble_forward(members, mean, std))
    qc = qc_stats_fn(edge_threshold=edge_threshold, edge_method=edge_method,
                     canny_low=canny_low, canny_high=canny_high)

    @torch.inference_mode()
    def program(images_u8: torch.Tensor, threshold: float):
        probs, probs_flip = forward_tta(images_u8)
        pred = remove_small_components(probs >= threshold, min_area)
        stats = qc(probs, probs_flip, images_u8, threshold)
        stats["fg_area"] = pred.to(torch.float32).mean((1, 2))
        return pred, probs, stats

    return program
