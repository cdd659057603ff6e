"""Driver of the SAM fine-tune cells: the port's `Trainer.train_step` on
SAM ViT-B as a MedSAM box-prompted fine-tune (on-card augmentation, one
jittered box a frame from its augmented mask, the model in its own bf16
compute dtype with its global blocks on the flash-attention kernels,
BCE+Dice on the upsampled logits, backward, per-group AdamW on the image
encoder and the mask decoder) on a pool of resident seeded batches,
cycled. It has the `train` driver's shape and kind, so the train span
metrics read it unchanged, and takes that driver's step, window,
profiled unit and release.

The traffic file gives what the train driver's does (batch, size, pool,
blob_grid, mask_grid, `trainer`, `optimizer`, `augment_params`,
`loss`, check_steps, limits) and `box_jitter`, MedSAM's 20 px, which
only the reference reads: its `box_gap` holds the port's own jitter
(train/engine.py `BOX_JITTER`) to it; the configuration file
the model's sizes (reference/sam.py `sizes_of`), at the traffic's size.

Set-up makes the weights on the card from the seed (weights_sam.py),
builds one TrainState through the Trainer (`build_model("sam_vit_b")`),
loads the weights and drives it through the first `check_steps` steps
with the window's own call, keeping each step's boxes and loss, the
first step's logits, AdamW's first moment after step 1 and the trained
parameters after the last. The window counts the flash kernels'
launches (ops/cuda/build.py `LAUNCHES`). The check replays the steps in
the plain reference (reference/sam.py) from the same weights, batches
and generator seed once the program is freed: the train cells' gaps, the
logits against the reference's own at bf16 operands, the boxes, and the
flash lane.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from cellbench import faults
from cellbench.drivers import train
from cellbench.drivers.train import profiled_unit, release, step  # noqa: F401
from cellbench.inputs import blob_frames, blob_masks
from cellbench.reference import sam as ref
from cellbench.reference import train as ref_train
from cellbench.reference.unet import bf16_round
from cellbench.weights_sam import make_weights

# query rows of the reference's global attention held at once
CHUNK = 512
# LAUNCHES keys of the flash kernels a global block runs in a step: the
# forward (float32 or bf16 route), dq, dkv
FLASH_FWD = ("flash_fwd", "flash_fwd_tc")
FLASH_BWD = ("flash_bwd_dq", "flash_bwd_dkv")

# the faults of the train kind that apply here (cellbench/faults.py
# plants by kind; the dry tests collect their cases by driver name)
faults.FAULTS.setdefault("train_sam",
                         {"half_batch": faults.FAULTS["train"]["half_batch"]})


def _launches():
    from cartseg_tpu_torch.ops.cuda.build import LAUNCHES

    return (sum(LAUNCHES[k] for k in FLASH_FWD),) + tuple(
        LAUNCHES[k] for k in FLASH_BWD)


def setup(cell, seed: int, device, log, hook=None):
    """The seeded weights in one TrainState, the pool of batches, and the
    first check_steps steps; `hook(ctx)` runs before the first step (a
    test plants a fault with it)."""
    t = cell.traffic
    sizes = ref.sizes_of(cell.config, t["size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_weights(sizes, gen, device)
    pool = [(blob_frames(gen, t["batch"], t["size"], t["blob_grid"], device),
             blob_masks(gen, t["batch"], t["size"], t["mask_grid"], device))
            for _ in range(t["pool"])]
    trainer = train._trainer(cell, device)
    state = trainer.init_state()
    state.model.load_state_dict(params)
    aug_seed = seed + train.AUG_SEED_OFFSET
    state.gen.manual_seed(aug_seed)
    gids = trainer.group_ids(state)
    lrs = [t["optimizer"]["lr"] * s
           for s in t["optimizer"]["group_lr_scales"]]
    ctx = SimpleNamespace(
        kind="train", cell=cell, seed=seed, device=device, log=log,
        encoder=cell.config["encoder"], sizes=sizes, params=params,
        pool=pool, trainer=trainer, state=state, gids=gids, lrs=lrs,
        active=[1.0, 1.0, 1.0], sample_w=torch.ones(t["batch"],
                                                     device=device),
        aug_seed=aug_seed, batch=t["batch"], size=t["size"], step_index=0)
    if hook is not None:
        hook(ctx)
    first, boxes = {}, []

    def keep_logits(module, inputs, out):
        first.setdefault("logits",
                         out.detach().to(torch.float32).permute(0, 2, 3, 1))

    def keep_boxes(module, inputs):
        boxes.append(inputs[1].detach().clone())

    hooks = [state.model.register_forward_hook(keep_logits),
             state.model.register_forward_pre_hook(keep_boxes)]
    losses = []
    for s in range(t["check_steps"]):
        loss, _, _ = step(ctx)
        losses.append(loss)
        if s == 0:
            first["mu"] = {k: state.opt.mu[k].detach().clone() for k in gids}
    for h in hooks:
        h.remove()
    b1 = t["optimizer"]["b1"]
    losses = [float(x) for x in losses]
    ctx.program_steps = {
        "losses": losses,
        "regions": losses,
        # AdamW's first moment after one step from zero is (1 - b1) g
        "first_grad": {k: v / (1.0 - b1) for k, v in first["mu"].items()},
        "params": {k: p.detach().clone()
                   for k, p in state.model.named_parameters() if k in gids},
        # not under "logits": calibrate.py reads a program's "logits" as
        # the ABL stage's input
        "first_logits": first["logits"],
        "boxes": boxes,
    }
    return ctx


def window(ctx, seconds: float) -> dict:
    """The train driver's window (train_img_per_s and train_step_p90_ms
    taken as there), counting the flash kernels' launches."""
    before = _launches()
    out = train.window(ctx, seconds)
    ctx.flash_launches = (out["units"], tuple(
        a - b for a, b in zip(_launches(), before)))
    return out


def flash_lane(ctx) -> float:
    """Over the window's steps, the launches of the flash forward, dq and
    dkv kernels away from one each a global block a step: sum over the
    three of |launches - blocks x steps| / steps. On a card every global
    block takes the kernels; the CPU takes their plain versions, which
    launch none."""
    n, got = ctx.flash_launches
    blocks = len(ctx.sizes.global_attn_indexes) \
        if ctx.device.type == "cuda" else 0
    return sum(abs(g - blocks * n) for g in got) / max(n, 1)


def reference_steps(ctx, quant=None, quant_grad=None) -> dict:
    """The reference's steps (with quant, the control's); the reference's
    own also read the first step's logits at bf16 operands, the
    yardstick of the forward's rounding."""
    t = ctx.cell.traffic
    return ref.follow(ctx.sizes, ctx.params, ctx.pool[:t["check_steps"]],
                      ctx.aug_seed, t, quant, quant_grad,
                      bf16_round if quant is None else None, CHUNK)


def readings(ctx, steps: dict, reference: dict) -> dict:
    """Every number the check can hold, of the program's `steps` against
    the reference's: reference/train.py `gaps` (with `logits_ratio` on
    the first step's logits), `first_loss_gap` (the first step's relative
    loss gap, from equal weights: the later steps' follow Adam's sign-like
    first update), `box_gap` and `flash_lane`."""
    out = ref_train.gaps(dict(steps, logits=steps["first_logits"]),
                         reference, ctx.params)
    out["first_loss_gap"] = abs(steps["losses"][0] - reference["losses"][0]) \
        / reference["losses"][0]
    out["box_gap"] = ref.box_gap(steps["boxes"], reference["boxes"])
    out["flash_lane"] = flash_lane(ctx)
    return out


def check(ctx, limits: dict):
    """(the numbers held to `limits`, the count of checked steps judged
    wrong)."""
    every = readings(ctx, ctx.program_steps, reference_steps(ctx))
    numbers = {k: every[k] for k in limits}
    wrong = ctx.cell.traffic["check_steps"] \
        if any(v > limits[k] for k, v in numbers.items()) else 0
    return numbers, wrong
