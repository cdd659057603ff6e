"""Plain PyTorch training steps of the smp UNet trainers: the on-card
augmentation of train_bce_dice.py (albumentations' pipeline as the JAX
package defines its parameter draws), BCE+Dice, the Active Boundary
Loss of train_BCEDice_ABL.py (an exact Euclidean distance transform and
the label-smoothed cross-entropy written out), gradients by autograd,
and per-group AdamW.

The augmentation's randomness is an input: the draws of a batch are made
from a generator seeded as the program's, in the order the trainer
documents (data/augment.py `draw_augment`: 17 x B uniforms, 9 uniforms
of the shared warp, B x H x W x 3 normals), and each op is written here
from its definition. float32 throughout with TF32 off; imports nothing
of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from cellbench.reference.unet import Net, fp32_flags, trainable

# the reference ABL's neighbour offsets (abl.py:121-127): dx moves along
# H, dy along W; index 8 is the pixel itself
ABL_DX = (1, -1, 0, 0, -1, 1, -1, 1, 0)
ABL_DY = (0, 0, -1, 1, 1, 1, -1, -1, 0)
ABL_MAX_DIS = 1e5
# how far an implementation's float32 rounding of the ABL's threshold grid
# point 1e-5 * 1.2^k may lie from the float64 one (2e-6 at k = 60, 4e-6
# at k = 100), with room
ABL_EPS_ROUNDING = 1e-5
BLUR_OFFSETS = (((0, -1), (0, 1)), ((-1, 0), (1, 0)),
                ((-1, -1), (1, 1)), ((-1, 1), (1, -1)))


# -------------------------------------------------------- augmentation

def draws(gen: torch.Generator, B: int, H: int, W: int, device):
    U = torch.rand((17, B), generator=gen, device=device)
    u = torch.rand((9,), generator=gen, device=device)
    noise = torch.randn((B, H, W, 3), generator=gen, device=device)
    return U, u, noise


def _uniform(u, lo, hi):
    return lo + (hi - lo) * u


def _fold101(c, n):
    """BORDER_REFLECT_101 of a coordinate into [0, n - 1]."""
    period = 2.0 * (n - 1)
    c = torch.remainder(c.abs(), period)
    return torch.where(c > n - 1, period - c, c)


def _warp(img, mask, angle, scale):
    """The shared affine about the centre: bilinear for frames, nearest for
    masks, reflect-101 outside; img [B,C,H,W] float, mask [B,1,H,W]."""
    B, C, H, W = img.shape
    dev = img.device
    th = -angle * math.pi / 180.0
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    dy, dx = yy - cy, xx - cx
    sy = _fold101((torch.cos(th) * dy - torch.sin(th) * dx) / scale + cy, H)
    sx = _fold101((torch.sin(th) * dy + torch.cos(th) * dx) / scale + cx, W)
    y0, x0 = sy.floor(), sx.floor()
    wy, wx = sy - y0, sx - x0
    y0, x0 = y0.long().clamp(0, H - 1), x0.long().clamp(0, W - 1)
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    out = (img[:, :, y0, x0] * (1 - wy) * (1 - wx)
           + img[:, :, y0, x1] * (1 - wy) * wx
           + img[:, :, y1, x0] * wy * (1 - wx) + img[:, :, y1, x1] * wy * wx)
    yn = sy.round().long().clamp(0, H - 1)
    xn = sx.round().long().clamp(0, W - 1)
    return out, mask[:, :, yn, xn]


def _to_hsv(rgb):
    """[B,3,H,W] in [0,1] -> h in [0,1), s, v."""
    r, g, b = rgb.unbind(1)
    v = torch.maximum(torch.maximum(r, g), b)
    d = v - torch.minimum(torch.minimum(r, g), b)
    dd = torch.where(d > 0, d, 1.0)
    h = torch.where(v == r, torch.remainder((g - b) / dd, 6.0),
                    torch.where(v == g, (b - r) / dd + 2.0,
                                (r - g) / dd + 4.0))
    h = torch.where(d > 0, h, 0.0) / 6.0
    s = torch.where(v > 0, d / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v


def _from_hsv(h, s, v):
    """The standard sector formula: f(n) = v - v s max(0, min(k, 4 - k, 1))
    with k = (n + 6 h) mod 6, for n = 5, 3, 1."""
    def f(n):
        k = torch.remainder(n + 6.0 * h, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
    return torch.stack([f(5.0), f(3.0), f(1.0)], 1)


def augment(images_u8, masks, params: dict, U, u, noise):
    """(normalised float32 NCHW frames, float32 [B,1,H,W] masks) of the
    train_512 pipeline at the given draws: flip, the shared rotate and
    zoom, brightness/contrast, HSV shift, Gaussian noise, motion blur,
    then (x / 255 - mean) / std."""
    a = params
    img = images_u8.permute(0, 3, 1, 2).to(torch.float32)
    m = masks.permute(0, 3, 1, 2).to(torch.float32)
    B, _, H, W = img.shape

    def gate(i, p):
        return (U[i] < p)[:, None, None, None]

    flip = gate(0, a["hflip_p"])
    img = torch.where(flip, img.flip(3), img)
    m = torch.where(flip, m.flip(3), m)
    angle = torch.where(u[0] < a["rotate_p"],
                        _uniform(u[1], -a["rotate_limit"], a["rotate_limit"]),
                        0.0)
    scale = torch.where(u[2] < a["scale_p"],
                        1.0 + _uniform(u[3], -a["scale_limit"],
                                       a["scale_limit"]), 1.0)
    img, m = _warp(img, m, angle, scale)
    col = lambda x: x[:, None, None, None]  # noqa: E731
    alpha = col(1.0 + _uniform(U[2], -a["contrast_limit"],
                               a["contrast_limit"]))
    beta = col(_uniform(U[3], -a["brightness_limit"],
                        a["brightness_limit"]) * 255.0)
    img = torch.where(gate(1, a["brightness_contrast_p"]),
                      (img * alpha + beta).clamp(0, 255), img)
    h, s, v = _to_hsv(img / 255.0)
    dh = _uniform(U[5], -a["hue_shift"], a["hue_shift"]) / 180.0
    ds = _uniform(U[6], -a["sat_shift"], a["sat_shift"]) / 255.0
    dv = _uniform(U[7], -a["val_shift"], a["val_shift"]) / 255.0
    shifted = _from_hsv(torch.remainder(h + dh[:, None, None], 1.0),
                        (s + ds[:, None, None]).clamp(0, 1),
                        (v + dv[:, None, None]).clamp(0, 1))
    img = torch.where(gate(4, a["hsv_p"]), (shifted * 255.0).clamp(0, 255),
                      img)
    var = col(_uniform(U[14], a["noise_var"][0], a["noise_var"][1]))
    img = torch.where(gate(13, a["noise_p"]),
                      (img + noise.permute(0, 3, 1, 2) * var.sqrt())
                      .clamp(0, 255), img)
    d = min(int(float(U[16, 0]) * 4.0), 3)
    (a1, b1), (a2, b2) = BLUR_OFFSETS[d]
    blurred = (img + torch.roll(img, (a1, b1), (2, 3))
               + torch.roll(img, (a2, b2), (2, 3))) / 3.0
    img = torch.where(gate(15, a["motion_blur_p"]), blurred, img)
    mean = torch.tensor(a["mean"], device=img.device)[None, :, None, None]
    std = torch.tensor(a["std"], device=img.device)[None, :, None, None]
    return (img / 255.0 - mean) / std, m


# --------------------------------------------------------------- losses

def bce_dice(logits, y, bce_weight: float, smooth: float):
    """w BCE + (1 - w)(1 - mean over samples of the soft Dice)."""
    bce = F.binary_cross_entropy_with_logits(logits, y)
    p = torch.sigmoid(logits)
    inter = (p * y).sum((1, 2, 3))
    den = p.sum((1, 2, 3)) + y.sum((1, 2, 3))
    dice = ((2.0 * inter + smooth) / (den + smooth)).mean()
    return bce_weight * bce + (1.0 - bce_weight) * (1.0 - dice)


def edt(seeds: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance from each pixel to the nearest True pixel
    of [B,H,W] seeds (inf where an image has none): the column pass
    gives each pixel's squared distance to its column's nearest seed, the
    row pass the minimum over the row of that plus the squared offset."""
    B, H, W = seeds.shape
    dev = seeds.device
    ys = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    inf = torch.tensor(float("inf"), device=dev)
    above = torch.where(seeds, ys, -inf).cummax(1).values
    below = torch.where(seeds, ys, inf).flip(1).cummin(1).values.flip(1)
    col = torch.minimum((ys - above).square(), (below - ys).square())
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    off = (xs[:, None] - xs[None, :]).square()        # [x, x']
    out = torch.empty_like(col)
    for b in range(B):
        out[b] = (col[b][:, None, :] + off[None]).amin(2)
    return out.sqrt()


def _kl(a, b):
    """The reference's kl_div(log_softmax(a), softmax(b)) summed over the
    classes, applied to probabilities as if they were logits."""
    return (torch.softmax(b, -1) * (torch.log_softmax(b, -1)
                                    - torch.log_softmax(a, -1))).sum(-1)


def abl(logits, target, max_n_ratio=0.01, label_smoothing=0.2,
        max_clip_dist=20.0, eps_shift=0.0):
    """Active Boundary Loss of binary logits [B,H,W,1] against integer
    target [B,H,W]; (loss, used) with used False where the predicted
    boundary or its valid pixels are empty. `eps_shift` moves the
    threshold's grid points by that share of themselves."""
    B, H, W, _ = logits.shape
    pf = torch.sigmoid(logits[..., 0])
    probs = torch.stack([1.0 - pf, pf], -1)
    with torch.no_grad():
        gb = (F.pad(target[:, 1:] - target[:, :-1], (0, 0, 0, 1)) != 0) \
            | (F.pad(target[:, :, 1:] - target[:, :, :-1], (0, 1)) != 0)
        dist = (edt(gb) - 1.0).clamp(min=0.0)
        dist = torch.where(gb.any((1, 2))[:, None, None], dist, 0.0)
        kl = F.pad(_kl(probs[:, 1:], probs[:, :-1]), (0, 0, 0, 1)) \
            + F.pad(_kl(probs[:, :, 1:], probs[:, :, :-1]), (0, 1))
        max_n = H * W * max_n_ratio
        eps = 1e-5
        while int((kl > eps * (1.0 + eps_shift)).sum()) > max_n:
            eps *= 1.2
        pred_b = F.max_pool2d((kl > eps * (1.0 + eps_shift))
                              .to(torch.float32)[:, None], 3, 1, 1)[:, 0] > 0
        dpad = F.pad(dist, (1, 1, 1, 1), value=ABL_MAX_DIS)
        dstack = torch.stack([dpad[:, 1 + dx:1 + dx + H, 1 + dy:1 + dy + W]
                              for dx, dy in zip(ABL_DX, ABL_DY)])
        direction = dstack.argmin(0)
    ppad = F.pad(probs.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode="replicate").permute(0, 2, 3, 1).detach()
    kls = torch.stack([_kl(probs, ppad[:, 1 + dx:1 + dx + H,
                                       1 + dy:1 + dy + W])
                       for dx, dy in zip(ABL_DX[:8], ABL_DY[:8])], -1)
    valid = pred_b & (direction != 8)
    label = torch.where(direction == 8, 0, direction)
    onehot = F.one_hot(label, 8).to(torch.float32)
    smooth = onehot * (1.0 - label_smoothing) \
        + (1.0 - onehot) * (label_smoothing / 8)
    ce = -(torch.log_softmax(kls, -1) * smooth).sum(-1)
    weight = dist.clamp(max=max_clip_dist) / max_clip_dist
    n_valid = valid.sum()
    loss = (ce * weight * valid).sum() / n_valid.clamp(min=1)
    used = bool(pred_b.any()) and bool(n_valid > 0)
    return loss, used


def loss_of(logits_nchw, m, spec: dict):
    """(total, BCE+Dice) of the trainer's loss on NCHW logits and masks."""
    logits = logits_nchw.permute(0, 2, 3, 1)
    y = m.permute(0, 2, 3, 1)
    kw = spec.get("kwargs", {})
    region = bce_dice(logits, y, kw.get("bce_weight", 0.5),
                      kw.get("smooth", 1.0))
    if spec["name"] == "bce_dice":
        return region, region
    if spec["name"] == "bce_dice_abl":
        b, used = abl(logits, (y[..., 0] > 0.5).to(torch.int64))
        total = region + kw.get("abl_weight", 0.1) * b if used else region
        return total, region
    raise ValueError(f"no reference for the loss {spec['name']!r}")


# -------------------------------------------------------------- steps

def group_of(name: str) -> int:
    """encoder 0, decoder 1, head 2 (the trainer's parameter groups)."""
    if name.startswith("encoder."):
        return 0
    if name.startswith("segmentation_head."):
        return 2
    return 1


@torch.no_grad()
def adamw(P, grads, mu, nu, t: int, lrs, opt: dict) -> None:
    """AdamW step t (from 1) in place on P, mu, nu over the keys of grads:
    p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), the learning rate of
    each parameter's group."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for k, g in grads.items():
        mu[k] = b1 * mu[k] + (1 - b1) * g
        nu[k] = b2 * nu[k] + (1 - b2) * g * g
        mhat = mu[k] / (1 - b1 ** t)
        vhat = nu[k] / (1 - b2 ** t)
        P[k] = P[k] - lrs[group_of(k)] * (mhat / (vhat.sqrt() + eps)
                                          + wd * P[k])


def follow(encoder: str, params: Dict[str, torch.Tensor], batches: List,
           aug_seed: int, traffic: dict, quant=None, quant_grad=None,
           yard=None) -> dict:
    """The trainer's first len(batches) steps from `params`: each step's
    loss and its BCE+Dice part, the first step's logits (NHWC), gradient
    and augmented masks, and the parameters after the last step; with
    `yard`, also the first step's logits with every convolution's
    operands rounded by it."""
    opt = traffic["optimizer"]
    lrs = [opt["lr"] * s for s in opt["group_lr_scales"]]
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(aug_seed)
    P = {k: v.detach().clone() for k, v in params.items()}
    names = [k for k in P if trainable(k)]
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    losses, regions, first_grad, first_masks = [], [], None, None
    first_logits = yard_logits = None
    with fp32_flags():
        for t, (images_u8, masks) in enumerate(batches, start=1):
            B, H, W, _ = images_u8.shape
            x, m = augment(images_u8, masks, traffic["augment_params"],
                           *draws(gen, B, H, W, device))
            leaves = {k: P[k].requires_grad_(True) for k in names}
            logits = Net(encoder, P, train=True, quant=quant, remat=True,
                         quant_grad=quant_grad)(x)
            loss, region = loss_of(logits, m, traffic["loss"])
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            losses.append(float(loss.detach()))
            regions.append(float(region.detach()))
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
                first_masks = m.permute(0, 2, 3, 1)
                first_logits = logits.detach().permute(0, 2, 3, 1)
                if yard is not None:
                    with torch.no_grad():
                        yard_logits = Net(encoder, P, train=True,
                                          quant=yard)(x).permute(0, 2, 3, 1)
            for k in names:
                P[k] = P[k].detach()
            adamw(P, grads, mu, nu, t, lrs, opt)
    return {"losses": losses, "regions": regions, "first_grad": first_grad,
            "first_masks": first_masks, "logits": first_logits,
            "yard_logits": yard_logits,
            "params": {k: P[k].detach() for k in names}}


def _leaf_gaps(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor], keys) -> List[float]:
    """Each leaf's gap of norms, |‖a‖ - ‖b‖|, against the larger of the
    reference leaf's norm and the median leaf's."""
    pn = {k: float(prog[k].float().norm()) for k in keys}
    rn = {k: float(ref[k].float().norm()) for k in keys}
    med = float(torch.tensor(list(rn.values())).median())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def gaps(prog: dict, ref: dict, params0: Dict[str, torch.Tensor],
         quiet: float = 1e-3) -> Dict[str, float]:
    """Every number the comparison can hold to a limit (a cell's traffic
    file names those it holds):
      loss_gap, region_gap: the worst step's relative gap of the loss and
        of its BCE+Dice part;
      grad_gap, grad_gap_median: the first gradient's worst and median
        leaf;
      update_gap, update_gap_median: the worst and median leaf of the
        parameters' change over the steps, leaving out the leaves whose
        reference gradient is under `quiet` of the median leaf's (they
        move under Adam by round-off alone);
      logits_gap: the first step's forward, where `prog` kept its logits:
        mean |l - l_ref| over mean |l_ref|. A mean of gaps, which rounding
        below the forward's precision moves, where the gaps of norms
        above move by bias alone;
      logits_ratio: mean |l - l_ref| over the same of the reference's own
        logits with the convolutions' operands in bf16 (`yard_logits`):
        the seeded weights set how far any rounding carries through the
        model, by several times from seed to seed."""
    g_ref = ref["first_grad"]
    keys = list(g_ref)
    gn = {k: float(g_ref[k].norm()) for k in keys}
    med = float(torch.tensor(list(gn.values())).median())
    moving = [k for k in keys if gn[k] >= quiet * med]
    d_prog = {k: prog["params"][k].float() - params0[k] for k in moving}
    d_ref = {k: ref["params"][k] - params0[k] for k in moving}
    grad = _leaf_gaps(prog["first_grad"], g_ref, keys)
    update = _leaf_gaps(d_prog, d_ref, moving)
    out = {
        "loss_gap": max(_rel(a, b) for a, b in zip(prog["losses"],
                                                   ref["losses"])),
        "region_gap": max(_rel(a, b) for a, b in zip(prog["regions"],
                                                     ref["regions"])),
        "grad_gap": max(grad),
        "grad_gap_median": float(torch.tensor(grad).median()),
        "update_gap": max(update),
        "update_gap_median": float(torch.tensor(update).median()),
    }
    if prog.get("logits") is not None:
        lr = ref["logits"].to(torch.float32)
        gap = (prog["logits"].to(torch.float32) - lr).abs().mean()
        out["logits_gap"] = float(gap / lr.abs().mean())
        if ref.get("yard_logits") is not None:
            out["logits_ratio"] = float(gap / (ref["yard_logits"] - lr)
                                        .abs().mean().clamp(min=1e-30))
    return out


def abl_stage_gap(logits_nhwc: torch.Tensor, masks_nhwc: torch.Tensor,
                  boundary: float, dtype=torch.float32) -> float:
    """The ABL layer checked by itself on the program's own first-step
    logits and the step's augmented masks: the relative gap between the
    program's boundary term and this ABL's (computed in `dtype`; the
    control runs it in bf16). The smallest over the threshold's grid
    points as they are and moved by ABL_EPS_ROUNDING down and up: the
    predicted boundary is the KL values above a grid point, and those
    within its rounding fall on either side in a sound float32 program
    (bf16 logits make many KL values equal, so a whole cluster can)."""
    target = (masks_nhwc[..., 0] > 0.5).to(torch.int64)
    gaps = []
    with torch.no_grad():
        for shift in (0.0, -ABL_EPS_ROUNDING, ABL_EPS_ROUNDING):
            b, used = abl(logits_nhwc.to(dtype), target, eps_shift=shift)
            gaps.append(_rel(boundary, float(b) if used else 0.0))
    return min(gaps)
