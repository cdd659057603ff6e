"""Plain PyTorch pseudo-labelling of one batch: the weighted ensemble of
sigmoids with flip TTA, the connected-component cleanup and every QC
statistic of create_pseudo_labels.py (fg_area on the cleaned mask;
fg_conf, the exact median of |p - 0.5| * 2; mean_entropy; tta_iou;
edge_hit against Canny(50, 150)).

Written from the reference scripts' definitions, not from the port:
components are labelled by repeated 3x3 minimum passes and pointer
jumping, Canny is cv2's (Sobel-3 with a replicated border, L1
magnitude, non-maximum suppression in four sectors, hysteresis through
8-connected weak pixels) on BT.601 grey in float32, as the port
documents its grey. Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from cellbench.reference.unet import Net, fp32_flags

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TAN_22_5 = 0.4142135623730951
BT601 = (0.299, 0.587, 0.114)
SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def ensemble_probs(encoder: str, members: Sequence[Dict[str, torch.Tensor]],
                   weights: Sequence[float], images_u8: torch.Tensor,
                   quant=None, block: int = 16):
    """uint8 NHWC frames -> (probs, probs of the mirrored frames mirrored
    back), float32 [B,H,W], computed `block` frames at a time."""
    dev = images_u8.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    total = float(sum(weights))
    probs, flips = [], []
    with torch.no_grad(), fp32_flags():
        for i in range(0, images_u8.shape[0], block):
            x = ((images_u8[i:i + block].to(torch.float32) / 255.0 - mean)
                 / std).permute(0, 3, 1, 2)
            for out, xin in ((probs, x), (flips, x.flip(-1))):
                p = 0.0
                for params, w in zip(members, weights):
                    logits = Net(encoder, params, quant=quant)(xin)[:, 0]
                    p = p + (w / total) * torch.sigmoid(logits)
                out.append(p if xin is x else p.flip(-1))
    return torch.cat(probs), torch.cat(flips)


def _min_3x3(lab: torch.Tensor) -> torch.Tensor:
    return -F.max_pool2d(-lab[:, None], 3, 1, 1)[:, 0]


def components(mask: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool -> int64 [B,H,W]: each foreground pixel labelled with
    the smallest flat index (h * W + w) of its 8-connected component,
    H * W on the background."""
    B, H, W = mask.shape
    n = H * W
    idx = torch.arange(n, device=mask.device, dtype=torch.float32)
    lab = torch.where(mask, idx.view(1, H, W), float(n))
    while True:
        new = torch.where(mask, torch.minimum(lab, _min_3x3(lab)), float(n))
        flat = new.view(B, n).to(torch.int64)
        for _ in range(4):     # pointer jumping along the label chains
            hop = torch.where(flat < n, flat, 0)
            flat = torch.where(flat < n, flat.gather(1, hop), flat)
        new = flat.to(torch.float32).view(B, H, W)
        if torch.equal(new, lab):
            return lab.to(torch.int64)
        lab = new


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Each pixel's component size (background: its image's count)."""
    B, H, W = labels.shape
    n = H * W
    key = labels.view(B, n) + (n + 1) * torch.arange(
        B, device=labels.device)[:, None]
    counts = torch.bincount(key.reshape(-1), minlength=B * (n + 1))
    return counts[key].view(B, H, W)


def clean(mask: torch.Tensor, min_area: int) -> torch.Tensor:
    """Drop the 8-connected foreground components under min_area."""
    return mask & (component_sizes(components(mask)) >= min_area)


def _grey(images_u8: torch.Tensor, dtype) -> torch.Tensor:
    w = torch.tensor(BT601, dtype=dtype, device=images_u8.device)
    return images_u8.to(dtype) @ w


def canny(images_u8: torch.Tensor, low: float, high: float,
          dtype=torch.float32) -> torch.Tensor:
    """cv2.Canny(grey, low, high) on [B,H,W,3] uint8 frames -> bool, the
    grey and the gradients computed in `dtype` (the control: bf16)."""
    gray = _grey(images_u8, dtype)
    H, W = gray.shape[-2:]
    g = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")
    kx = torch.tensor(SOBEL_X, dtype=dtype, device=gray.device)
    grads = F.conv2d(g, torch.stack([kx, kx.T])[:, None])
    dx, dy = grads[:, 0], grads[:, 1]
    mag = dx.abs() + dy.abs()
    m = F.pad(mag, (1, 1, 1, 1))          # zero magnitude outside

    def nb(oy, ox):
        return m[:, 1 + oy:1 + oy + H, 1 + ox:1 + ox + W]

    ax, ay = dx.abs(), dy.abs()
    horizontal = ay < TAN_22_5 * ax
    vertical = ~horizontal & (ay > ax / TAN_22_5)
    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    # the gradient's signs agree: up-left against down-right
    same = (dx * dy) >= 0
    keep_d = torch.where(same, (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                         (mag > nb(-1, 1)) & (mag > nb(1, -1)))
    keep = torch.where(horizontal, keep_h,
                       torch.where(vertical, keep_v, keep_d))
    weak = keep & (mag > low)
    strong = keep & (mag > high)
    lab = components(weak)
    B, n = weak.shape[0], H * W
    key = lab.view(B, n) + (n + 1) * torch.arange(B, device=lab.device)[:,
                                                                        None]
    hit = torch.zeros(B * (n + 1), device=lab.device)
    hit.index_add_(0, key.reshape(-1), strong.reshape(-1).to(torch.float32))
    return weak & (hit[key].view(B, H, W) > 0)


def inner_boundary(mask: torch.Tensor) -> torch.Tensor:
    """Mask pixels with a background pixel among their 8 neighbours
    inside the frame."""
    bg = (~mask).to(torch.float32)[:, None]
    return mask & (F.max_pool2d(bg, 3, 1, 1)[:, 0] > 0)


def edge_hit(images_u8, pred, canny_low: float, canny_high: float,
             dtype=torch.float32) -> torch.Tensor:
    """The share of each mask's inner boundary on a Canny edge (0 where the
    boundary is empty)."""
    edges = canny(images_u8, canny_low, canny_high, dtype)
    bound = inner_boundary(pred)
    tot = bound.sum((1, 2)).to(torch.float32)
    hits = (edges & bound).sum((1, 2)).to(torch.float32)
    return torch.where(tot > 0, hits / tot.clamp(min=1), 0.0)


def qc_stats(probs, probs_flip, images_u8, cleaned, threshold: float,
             canny_low: float, canny_high: float,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The five QC statistics of a batch, computed in `dtype` (the
    control: bf16) and returned in float32."""
    B = probs.shape[0]
    pred = probs >= threshold
    p = probs.to(dtype)
    conf = ((p - 0.5).abs() * 2.0).view(B, -1).sort(1).values
    n = conf.shape[1]
    median = conf[:, n // 2] if n % 2 else \
        0.5 * (conf[:, n // 2 - 1] + conf[:, n // 2])
    pc = p.clamp(1e-6, 1.0 - 1e-6)
    entropy = -(pc * torch.log(pc) + (1.0 - pc) * torch.log(1.0 - pc))
    return {"fg_area": cleaned.to(torch.float32).mean((1, 2)),
            "fg_conf": median.to(torch.float32),
            "mean_entropy": entropy.mean((1, 2)).to(torch.float32),
            "tta_iou": iou(pred, probs_flip >= threshold, dtype),
            "edge_hit": edge_hit(images_u8, pred, canny_low, canny_high,
                                 dtype)}


def iou(a: torch.Tensor, b: torch.Tensor,
        dtype=torch.float32) -> torch.Tensor:
    """Each frame's intersection over union of two [B,H,W] masks (0 where
    the union is empty), the counts and their quotient in `dtype`."""
    inter = (a & b).sum((1, 2)).to(dtype)
    union = (a | b).sum((1, 2)).to(dtype)
    return torch.where(union > 0, inter / union.clamp(min=1),
                       0.0).to(torch.float32)


def pseudo_label(encoder: str, members, weights, images_u8,
                 threshold: float, min_area: int, canny_low: float,
                 canny_high: float, quant=None, qc_dtype=torch.float32):
    """(cleaned mask, probs, stats, probs of the mirrored frames mirrored
    back) of one batch, the first three as the pseudo-labeller writes
    them (the control: quant rounds the convolutions' operands to fp8,
    and the QC statistics are computed in bf16)."""
    probs, probs_flip = ensemble_probs(encoder, members, weights, images_u8,
                                       quant)
    with torch.no_grad():
        cleaned = clean(probs >= threshold, min_area)
        stats = qc_stats(probs, probs_flip, images_u8, cleaned, threshold,
                         canny_low, canny_high, qc_dtype)
    return cleaned, probs, stats, probs_flip


# the QC statistics that the reference works out again from the
# program's own probabilities and masks (tta_iou is held apart, against
# the program's own run on the mirrored frames: tta_stage_gap)
STAGE_STATS = ("fg_area", "fg_conf", "mean_entropy", "edge_hit")


def gaps(images_u8, pred, probs, stats, mirrored, ref_pred, ref_probs,
         ref_stats, ref_probs_flip, yard_probs, yard_flip,
         threshold: float, min_area: int, canny_low: float,
         canny_high: float) -> Dict[str, float]:
    """Every number the comparison can hold to a limit, for one batch (a
    cell's traffic file names those it holds). `mirrored` is the
    program's probabilities of the same frames mirrored left to right,
    from a call of its own, mirrored back; `yard_probs` and `yard_flip`
    the reference's own, and of the mirrored frames, with every
    convolution's operands rounded to bf16, the configuration's
    precision. Means over pixels or frames, not the widest gaps: one
    pixel's or frame's gap is the tail of millions and swings from seed
    to seed by several times.
      probs_gap: mean |p - p_ref|;
      flip_probs_gap: the mirrored frames' mean |p - p_ref|;
      probs_ratio, flip_probs_ratio: those over the yardstick's own
        (mean |p_bf16 - p_ref|): the seeded weights set how many pixels
        lie near the threshold, and so how large any rounding's gap is,
        by several times from seed to seed; the ratio reads the program's
        rounding against bf16's on the same weights and frames;
      mask_mismatch: the share of pixels on which the cleaned masks differ;
      qc_gap, tta_gap: the worst QC statistic's mean gap over the frames,
        and tta_iou's;
      qc_stage_gap: the QC statistics by themselves, from the program's
        own probabilities and masks: the worst of fg_area, fg_conf,
        mean_entropy and edge_hit's mean gap to this QC's;
      tta_stage_gap: tta_iou by itself: its mean gap over the frames to
        the IoU of the program's own masks of the frames and of the
        mirrored frames (the TTA's mirrored half, which the program
        hands out only through tta_iou);
      cleanup_diff: the CC cleanup by itself, on the program's own
        thresholded probabilities: the pixels on which the program's mask
        differs from this cleanup's (an exact comparison)."""
    def stat_gap(want, keys):
        return max(float((stats[k].to(torch.float32) - want[k]).abs()
                         .mean()) for k in keys)

    with torch.no_grad():
        own = clean(probs >= threshold, min_area)
        # the program's own masks and probabilities through this QC
        staged = qc_stats(probs, probs, images_u8, pred, threshold,
                          canny_low, canny_high)
        tta = {"tta_iou": iou(probs >= threshold, mirrored >= threshold)}
        gap = float((probs - ref_probs).abs().mean())
        flip_gap = float((mirrored - ref_probs_flip).abs().mean())
        return {
            "probs_gap": gap,
            "flip_probs_gap": flip_gap,
            "probs_ratio": gap / max(float(
                (yard_probs - ref_probs).abs().mean()), 1e-12),
            "flip_probs_ratio": flip_gap / max(float(
                (yard_flip - ref_probs_flip).abs().mean()), 1e-12),
            "mask_mismatch": float((pred != ref_pred).to(torch.float32)
                                   .mean()),
            "qc_gap": stat_gap(ref_stats, ref_stats),
            "tta_gap": stat_gap(ref_stats, ("tta_iou",)),
            "qc_stage_gap": stat_gap(staged, STAGE_STATS),
            "tta_stage_gap": stat_gap(tta, ("tta_iou",)),
            "cleanup_diff": float((own != pred).sum()),
        }


def worst(readings: List[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """The largest reading of each number over several batches."""
    if not readings:
        return None
    return {k: max(r[k] for r in readings) for k in readings[0]}
