"""Driver of the training cells: the port's `Trainer.train_step` (on-card
augmentation, bf16 autocast forward, the trainer's loss, backward,
per-group AdamW) on a pool of resident seeded batches, cycled.

The traffic file gives: batch, size, pool, blob_grid, mask_grid, the
trainer's settings (`trainer`: TrainConfig fields), the optimizer's
(`optimizer`: lr, group_lr_scales, weight_decay, b1, b2, eps), the
augmentation's parameters as the reference reads them
(`augment_params`), the loss (`loss`: name and kwargs), check_steps and
the check's limits.

Set-up builds one TrainState, loads the seeded weights into it and
drives it through the first `check_steps` steps with the window's own
call, on distinct batches; the window continues on the same state. The
check replays those steps in the plain reference
(cellbench/reference/train.py) from the same weights, batches and
augmentation seed, once the window has closed and the program's state
is freed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from cellbench.inputs import blob_frames, blob_masks
from cellbench.reference import train as ref
from cellbench.reference.unet import bf16_round
from cellbench.weights import make_weights, port_state_dict

# the augmentation generator's seed: the run's seed, moved off the
# weights' and inputs' stream
AUG_SEED_OFFSET = 7919


def _trainer(cell, device):
    from cartseg_tpu_torch.train import LossSpec, TrainConfig, Trainer

    t = cell.traffic
    size = t["size"]
    cfg = TrainConfig(**dict(t["trainer"], encoder=cell.config["encoder"],
                             img_size=(size, size), batch_size=t["batch"],
                             loss=LossSpec(t["loss"]["name"],
                                           dict(t["loss"]["kwargs"])),
                             lr=t["optimizer"]["lr"],
                             weight_decay=t["optimizer"]["weight_decay"],
                             device=str(device)))
    return Trainer(cfg)


def setup(cell, seed: int, device, log, hook=None):
    """The seeded weights in one TrainState, the pool of batches, and the
    first check_steps steps; `hook(ctx)` runs before the first step (a
    test plants a fault with it)."""
    t, encoder = cell.traffic, cell.config["encoder"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_weights(encoder, 1, gen, device)[0]
    pool = [(blob_frames(gen, t["batch"], t["size"], t["blob_grid"], device),
             blob_masks(gen, t["batch"], t["size"], t["mask_grid"], device))
            for _ in range(t["pool"])]
    trainer = _trainer(cell, device)
    state = trainer.init_state()
    state.model.load_state_dict(port_state_dict(params))
    aug_seed = seed + AUG_SEED_OFFSET
    state.gen.manual_seed(aug_seed)
    gids = trainer.group_ids(state)
    lrs = [t["optimizer"]["lr"] * s
           for s in t["optimizer"]["group_lr_scales"]]
    active = [1.0, 1.0, 1.0]
    w = torch.ones(t["batch"], device=device)
    ctx = SimpleNamespace(
        kind="train", cell=cell, seed=seed, device=device, log=log,
        encoder=encoder, params=params, pool=pool, trainer=trainer,
        state=state, gids=gids, lrs=lrs, active=active, sample_w=w,
        aug_seed=aug_seed, batch=t["batch"], size=t["size"], step_index=0)
    if hook is not None:
        hook(ctx)
    # the first steps go through the window's own call, on distinct
    # batches; what the check reads of them is kept: each step's loss and
    # its BCE+Dice part, AdamW's first moment after step 1, the model's
    # first logits (where the loss has an ABL term, checked by itself),
    # the parameters after the last
    first = {}

    def keep_logits(module, inputs, out):
        first.setdefault("logits",
                         out.detach().to(torch.float32).permute(0, 2, 3, 1))

    abl = t["loss"]["name"] == "bce_dice_abl"
    handle = state.model.register_forward_hook(keep_logits) if abl else None
    losses, regions = [], []
    for s in range(t["check_steps"]):
        loss, _, comps = step(ctx)
        losses.append(loss)
        regions.append(comps.get("region", loss))
        if s == 0:
            if handle is not None:
                handle.remove()
                first["boundary"] = comps["boundary"]
            first["mu"] = {k: v.detach().clone()
                           for k, v in state.opt.mu.items()}
    b1 = t["optimizer"]["b1"]
    ctx.program_steps = {
        "losses": [float(x) for x in losses],
        "regions": [float(x) for x in regions],
        # AdamW's first moment after one step from zero is (1 - b1) g
        "first_grad": {k: v / (1.0 - b1) for k, v in first["mu"].items()},
        "params": {k: p.detach().clone()
                   for k, p in state.model.named_parameters()},
        "logits": first.get("logits"),
        "boundary": float(first["boundary"]) if abl else None,
    }
    return ctx


def step(ctx):
    images, masks = ctx.pool[ctx.step_index % len(ctx.pool)]
    ctx.step_index += 1
    return ctx.trainer.train_step(ctx.state, images, masks, ctx.sample_w,
                                  ctx.lrs, ctx.active, ctx.gids)


def window(ctx, seconds: float) -> dict:
    cuda = ctx.device.type == "cuda"
    oks, marks = [], []

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())

    if cuda:
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    mark()
    while time.perf_counter() - t0 < seconds:
        _, ok, _ = step(ctx)
        oks.append(ok)
        mark()
    if cuda:
        torch.cuda.synchronize(ctx.device)
    dt = time.perf_counter() - t0
    n = len(oks)
    if cuda:
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    skipped = n - int(torch.stack(oks).sum()) if oks else 0
    return {"metrics": {"train_img_per_s": n * ctx.batch / dt,
                        "train_step_p90_ms": float(np.percentile(ms, 90))},
            "attempted": n, "failed": skipped, "units": n, "seconds": dt,
            "step_ms": ms}


def profiled_unit(ctx):
    return (lambda: step(ctx)), (lambda: torch.cuda.synchronize(ctx.device))


def release(ctx) -> None:
    ctx.trainer = ctx.state = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(ctx, quant=None, quant_grad=None) -> dict:
    """The reference's steps (with quant, the control's); the reference's
    own also read the first step's logits at bf16, the yardstick of the
    forward's rounding, where the program's logits are checked."""
    t = ctx.cell.traffic
    kept = ctx.program_steps.get("logits") is not None
    yard = bf16_round if quant is None and kept else None
    return ref.follow(ctx.encoder, ctx.params, ctx.pool[:t["check_steps"]],
                      ctx.aug_seed, t, quant, quant_grad, yard)


def readings(ctx, steps: dict, reference: dict) -> dict:
    """Every number the check can hold, of `steps` (the program's, or a
    control's) against the reference's."""
    out = ref.gaps(steps, reference, ctx.params)
    if steps.get("logits") is not None:
        out["abl_stage_gap"] = ref.abl_stage_gap(
            steps["logits"], reference["first_masks"], steps["boundary"])
    return out


def check(ctx, limits: dict):
    """(the numbers held to `limits`, the count of checked steps judged
    wrong)."""
    every = readings(ctx, ctx.program_steps, reference_steps(ctx))
    numbers = {k: every[k] for k in limits}
    wrong = ctx.cell.traffic["check_steps"] \
        if any(v > limits[k] for k, v in numbers.items()) else 0
    return numbers, wrong
