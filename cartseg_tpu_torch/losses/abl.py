"""Active Boundary Loss (counterpart of cartseg_tpu/losses/abl.py;
reference src/training/losses/abl.py:32-212), fully on the device:

  * the GT distance map comes from the jump-flood EDT (ops/edt.py: the
    CUDA kernel on the card), where the reference ran scipy per sample
    on the host;
  * direction targets are masked-dense over all pixels ([9,B,H,W]
    stacks; the boundary mask weights the final reduction) instead of a
    `torch.nonzero` gather;
  * the adaptive-eps `while` loop is its closed form: one whole-batch
    top-k (abl.py:73-94 of the JAX package);
  * the direction CE is `lsr_ce`, the LSR kernels' autograd Function.

Semantics notes for parity with the JAX package (see its docstring):
the reference offset table (index 8 is the centre), `kl_div` applied to
probabilities as if they were logits, max(0, EDT - 1) distances with a
zero map for a sample without boundary, and (loss, n_valid) returned so
the caller skips the term where n_valid == 0 with no host sync.

Under data parallelism (`bce_dice_abl_over(group, ...)`, the ranks
whose rows make the batch; the public names keep the JAX signatures)
the two batch-wide reductions are the global batch's, exactly:
  * eps: n(v) = ceil(log(max(v, 1e-5) / 1e-5) / log 1.2) is monotone in
    v, so the grid index of the global (k+1)-th largest KL value is the
    global (k+1)-th largest n, read from an all-reduced histogram of n
    over N_BINS bins (every finite float32 v has n < N_BINS); the
    count(kl > eps) > max_N correction takes one all-reduced count;
  * the loss: sum(contrib) and n_valid are all-reduced, and each rank's
    loss is world-size times its share sum(contrib_rank) / n_valid,
    because DDP averages the ranks' gradients. The mean of the ranks'
    losses is the global loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cartseg_tpu_torch.losses.label_smooth import lsr_ce
from cartseg_tpu_torch.losses.region import bce_dice_loss
from cartseg_tpu_torch.ops.edt import edt_batch
from cartseg_tpu_torch.parallel import mesh

# reference offset table (abl.py:121-127); dx indexes H, dy indexes W
_X_RANGE = (1, -1, 0, 0, -1, 1, -1, 1, 0)
_Y_RANGE = (0, 0, -1, 1, 1, 1, -1, -1, 0)
_MAX_DIS = 1e5
# grid indices 0..N_BINS-1: n(float32 max) = 550
N_BINS = 560


def _kl_div(a, b):
    """softmax(b) * (log_softmax(b) - log_softmax(a)), channels-last."""
    return torch.softmax(b, -1) * (torch.log_softmax(b, -1)
                                   - torch.log_softmax(a, -1))


def gt2boundary(gt: torch.Tensor, ignore_label: int = 255) -> torch.Tensor:
    """[B,H,W] int labels -> [B,H,W] bool boundary (abl.py:89-101):
    1-px finite-difference edges; the ignore area counts as boundary."""
    ud = F.pad(gt[:, 1:, :] - gt[:, :-1, :], (0, 0, 0, 1)) != 0
    lr = F.pad(gt[:, :, 1:] - gt[:, :, :-1], (0, 1)) != 0
    return ud | lr | (gt == ignore_label)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on like's device, made by a fill kernel
    (no host-to-device copy)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _grid_index(v: torch.Tensor, base, grid) -> torch.Tensor:
    """n(v): the index of the smallest grid point 1e-5 * 1.2^n >= v."""
    return torch.ceil(torch.log(torch.maximum(v, base) / base)
                      / torch.log(grid))


def _global_grid_index(flat: torch.Tensor, k: int, base, grid,
                       group) -> torch.Tensor:
    """n of the (k+1)-th largest value of the ranks' `flat` together
    (n(global min - 1) where they hold k+1 values or fewer), from an
    all-reduced histogram of n."""
    total = mesh.all_reduce_sum(
        torch.full((1,), flat.numel(), dtype=torch.float64,
                   device=flat.device), group)
    if k + 1 > int(total.item()):
        lo = mesh.all_reduce_min(flat.min().reshape(1), group)[0]
        return torch.clamp(_grid_index(lo - 1.0, base, grid), min=0.0)
    n = torch.nan_to_num(torch.clamp(_grid_index(flat, base, grid), 0,
                                     N_BINS - 1), nan=0.0)
    hist = mesh.all_reduce_sum(torch.bincount(
        n.to(torch.int64), minlength=N_BINS).to(torch.float64), group)
    # at_least[t] = count(n >= t): the answer is the largest t with
    # count(n >= t) >= k + 1
    at_least = hist.flip(0).cumsum(0).flip(0)
    return ((at_least >= k + 1).sum() - 1).to(torch.float32)


def logits2boundary(probs2: torch.Tensor,
                    max_N_ratio: float = 1.0 / 100,
                    group=None) -> torch.Tensor:
    """[B,H,W,2] class scores -> [B,H,W] bool predicted boundary
    (abl.py:65-87): neighbour-KL edges, the adaptive eps (the smallest
    1e-5 * 1.2^k with count(kl > eps) <= max_N, from the (max_N+1)-th
    largest kl of the whole batch: of the group's ranks together under
    data parallelism), then a 3x3 dilation."""
    B, H, W, _ = probs2.shape
    max_N = (H * W) * max_N_ratio  # per the reference: image-area budget
    with torch.no_grad():
        kl_ud = _kl_div(probs2[:, 1:], probs2[:, :-1]).sum(-1)
        kl_lr = _kl_div(probs2[:, :, 1:], probs2[:, :, :-1]).sum(-1)
        kl = F.pad(kl_ud, (0, 0, 0, 1)) + F.pad(kl_lr, (0, 1))
        flat = kl.reshape(-1)
        k = int(max_N)
        base = _scalar(1e-5, flat)
        grid = _scalar(1.2, flat)
        if group is not None:
            n = _global_grid_index(flat, k, base, grid, group)
        else:
            if k + 1 <= flat.shape[0]:
                kth = torch.topk(flat, k + 1).values[-1]
            else:
                kth = flat.min() - 1.0
            n = _grid_index(kth, base, grid)
        eps = base * torch.pow(grid, torch.clamp(n, min=0.0))
        # kth may sit exactly on a grid point, where `>` already keeps
        # the count within budget
        over = mesh.all_reduce_sum((flat > eps).sum().reshape(1), group)[0]
        eps = torch.where(over > max_N, eps * grid, eps)
        edge = (kl > eps).to(torch.float32)
        dil = F.max_pool2d(edge[:, None], 3, stride=1, padding=1)[:, 0]
    return dil > 0


def gt_dist_maps(gt_boundary: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool -> [B,H,W] float32: max(0, EDT(boundary) - 1); zero
    for a sample with no boundary (abl.py:17-24)."""
    d = torch.clamp(edt_batch(gt_boundary) - 1.0, min=0.0)
    has = gt_boundary.any(dim=(1, 2))[:, None, None]
    return torch.where(has, d, 0.0)


def _pad_replicate(x: torch.Tensor) -> torch.Tensor:
    """Pad [B,H,W,C] by 1 px replicating edges (abl.py:115-119)."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode="replicate").permute(0, 2, 3, 1)


def active_boundary_loss(
    logits: torch.Tensor, target: torch.Tensor,
    max_N_ratio: float = 1.0 / 100,
    ignore_label: int = 255,
    label_smoothing: float = 0.2,
    max_clip_dist: float = 20.0,
    isdetach: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ABL forward. logits [B,H,W,1] (binary) or [B,H,W,C]; target
    [B,H,W] or [B,H,W,1] integer-valued. Returns (loss, n_valid) as
    device tensors; use the loss only where n_valid > 0."""
    return _active_boundary_loss(logits, target, None, max_N_ratio,
                                 ignore_label, label_smoothing,
                                 max_clip_dist, isdetach)


def _active_boundary_loss(logits, target, group,
                          max_N_ratio: float = 1.0 / 100,
                          ignore_label: int = 255,
                          label_smoothing: float = 0.2,
                          max_clip_dist: float = 20.0,
                          isdetach: bool = True):
    """`active_boundary_loss` over `group`'s ranks (None: alone): logits
    and target are this rank's rows of the batch, n_valid the global one
    and the loss world-size times this rank's share of the global
    loss."""
    logits = logits.to(torch.float32)
    if target.dim() == 4:
        target = target[..., 0]
    target = target.to(torch.int32)

    if logits.shape[-1] == 1:
        pf = torch.sigmoid(logits[..., 0])
        probs = torch.stack([1.0 - pf, pf], dim=-1)  # abl.py:188-191
    else:
        probs = torch.softmax(logits, -1)

    with torch.no_grad():
        gt_bound = gt2boundary(target, ignore_label)
        dist_map = gt_dist_maps(gt_bound)
    pred_bound = logits2boundary(probs, max_N_ratio, group)
    n_pred = pred_bound.sum()

    _, H, W = dist_map.shape
    dist_pad = F.pad(dist_map, (1, 1, 1, 1), value=_MAX_DIS)
    dist_stack = torch.stack(
        [dist_pad[:, 1 + dx:1 + dx + H, 1 + dy:1 + dy + W]
         for dx, dy in zip(_X_RANGE, _Y_RANGE)], dim=0)  # [9,B,H,W]

    probs_pad = _pad_replicate(probs)
    kls = []
    for dx, dy in zip(_X_RANGE[:8], _Y_RANGE[:8]):
        nb = probs_pad[:, 1 + dx:1 + dx + H, 1 + dy:1 + dy + W, :]
        if isdetach:
            nb = nb.detach()
        kls.append(_kl_div(probs, nb).sum(-1))
    kl_stack = torch.stack(kls, dim=-1)  # [B,H,W,8]

    direction_gt = torch.argmin(dist_stack, dim=0)  # [B,H,W] in [0,9)
    valid = pred_bound & (direction_gt != 8)
    weight_ce = torch.clamp(dist_map, max=max_clip_dist) / max_clip_dist
    safe_gt = torch.where(direction_gt == 8, 0, direction_gt)
    ce = lsr_ce(kl_stack, safe_gt, label_smoothing, ignore_label)
    contrib = ce * weight_ce * valid.to(torch.float32)
    n_valid = valid.sum()
    if group is not None:
        counts = mesh.all_reduce_sum(torch.stack([n_valid, n_pred]), group)
        n_valid, n_pred = counts[0], counts[1]
        scale = float(mesh.world_size(group))
        loss = contrib.sum() * scale / torch.clamp(n_valid, min=1)
    else:
        loss = contrib.sum() / torch.clamp(n_valid, min=1)
    # an empty predicted boundary -> the caller skips (n_valid carries it)
    n_valid = torch.where(n_pred < 1, 0, n_valid)
    return loss, n_valid


def bce_dice_abl(logits, targets, bce_weight: float = 0.5,
                 abl_weight: float = 0.1, **abl_kwargs):
    """BCEDiceABL composite (src/training/train_BCEDice_ABL.py:264-302):
    region = BCE+Dice, boundary = ABL (skipped when degenerate). Returns
    (total, {region, boundary, boundary_used}), all device tensors."""
    return bce_dice_abl_over(None, logits, targets, bce_weight, abl_weight,
                             **abl_kwargs)


def bce_dice_abl_over(group, logits, targets, bce_weight: float = 0.5,
                      abl_weight: float = 0.1, **abl_kwargs):
    """`bce_dice_abl` on this rank's rows of a batch that `group`'s ranks
    hold together (None: alone): the mean of the ranks' totals and of
    their components is the global batch's."""
    region = bce_dice_loss(logits, targets, bce_weight=bce_weight)
    targ_int = (targets[..., 0] > 0.5).to(torch.int32)
    abl, n_valid = _active_boundary_loss(logits, targ_int, group,
                                         **abl_kwargs)
    use = (n_valid > 0).to(torch.float32)
    total = region + abl_weight * abl * use
    return total, {"region": region, "boundary": abl * use,
                   "boundary_used": use}
