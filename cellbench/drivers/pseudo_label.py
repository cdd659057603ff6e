"""Driver of the pseudo-labelling cells: the port's
`pseudo_label_program` over a pool of resident seeded batches, with the
host copies of pred, probs and stats that the workload's loop makes
(infer/pseudo_labels.py), as `generate_pseudo_labels` drives it.

The traffic file gives: members, batch, size, pool (distinct batches,
cycled), blob_grid, head_gain, threshold, min_area_frac, canny_low,
canny_high, check_batches (the window's batches sampled for the check)
and the check's limits.

The check: once the window has closed, the program labels each of a
sample of the window's batches, drawn from the seed (a reservoir over
every batch of the window), once more with its frames mirrored left to
right: the TTA's mirrored half reaches the host only through tta_iou,
and this call shows what that half should have been. Once the program
is freed, the plain reference (cellbench/reference/pseudo_label.py)
pseudo-labels the sampled batches again in float32 from the same
weights and frames, and the program's host copies are held to it.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import numpy as np
import torch

from cellbench.inputs import blob_frames
from cellbench.reference import pseudo_label as ref
from cellbench.reference.unet import bf16_round
from cellbench.weights import make_weights, port_state_dict

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def build_program(encoder: str, params, traffic: dict, device):
    """The port's members (bf16 on a card) and its pseudo-label program."""
    from cartseg_tpu_torch.infer.engine import (EnsembleMember,
                                                prepare_model,
                                                pseudo_label_program)
    from cartseg_tpu_torch.models.factory import build_model

    members = []
    for sd in params:
        with torch.device("meta"):
            model = build_model(encoder)
        model = model.to_empty(device=device)
        model.load_state_dict(port_state_dict(sd))
        members.append(EnsembleMember(prepare_model(model, device), 1.0,
                                      traffic["threshold"]))
    size = traffic["size"]
    min_area = int(size * size * traffic["min_area_frac"])
    program = pseudo_label_program(
        members, IMAGENET_MEAN, IMAGENET_STD, min_area, edge_method="canny",
        canny_low=traffic["canny_low"], canny_high=traffic["canny_high"])
    return members, program, min_area


def _to_host(pred, probs, stats):
    """The workload loop's host copies (infer/pseudo_labels.py)."""
    return (pred.cpu().numpy().astype(np.uint8), probs.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in stats.items()})


def setup(cell, seed: int, device, log, hook=None):
    """Weights, the pool of batches and the program, warmed on every batch
    of the pool; `hook(ctx)` runs before the first call (a test plants a
    fault with it)."""
    t, encoder = cell.traffic, cell.config["encoder"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = make_weights(encoder, t["members"], gen, device, t["head_gain"])
    pool = [blob_frames(gen, t["batch"], t["size"], t["blob_grid"], device)
            for _ in range(t["pool"])]
    members, program, min_area = build_program(encoder, params, t, device)
    ctx = SimpleNamespace(
        kind="pseudo_label", cell=cell, seed=seed, device=device, log=log,
        encoder=encoder, params=params, pool=pool, members=members,
        program=program, min_area=min_area, threshold=float(t["threshold"]),
        mean=IMAGENET_MEAN, std=IMAGENET_STD, batch=t["batch"],
        size=t["size"], kept=[])
    if hook is not None:
        hook(ctx)
    for images in pool:          # every shape of the window, warmed
        _to_host(*ctx.program(images, ctx.threshold))
    return ctx


def window(ctx, seconds: float) -> dict:
    rng = random.Random(ctx.seed)
    k = ctx.cell.traffic["check_batches"]
    n, kept = 0, []
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = n % len(ctx.pool)
        out = _to_host(*ctx.program(ctx.pool[i], ctx.threshold))
        # reservoir sampling: each batch of the window is kept with
        # probability k / (n + 1)
        if n < k:
            kept.append((i, out))
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = (i, out)
        n += 1
    dt = time.perf_counter() - t0
    ctx.kept = kept
    mirror(ctx)
    return {"metrics": {"pseudo_label_img_per_s": n * ctx.batch / dt},
            "attempted": n, "failed": 0, "units": n, "seconds": dt}


def mirror(ctx) -> None:
    """The program once more on each sampled batch with its frames
    mirrored left to right; its probabilities, mirrored back, are kept
    for the check."""
    ctx.mirrored = [np.ascontiguousarray(
        _to_host(*ctx.program(ctx.pool[i].flip(2), ctx.threshold))[1]
        [:, :, ::-1]) for i, _ in ctx.kept]


def profiled_unit(ctx):
    def unit():
        _to_host(*ctx.program(ctx.pool[0], ctx.threshold))

    return unit, lambda: torch.cuda.synchronize(ctx.device)


def release(ctx) -> None:
    ctx.program = ctx.members = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_outputs(ctx, images, quant=None, qc_dtype=torch.float32):
    t = ctx.cell.traffic
    return ref.pseudo_label(ctx.encoder, ctx.params, [1.0] * len(ctx.params),
                            images, ctx.threshold, ctx.min_area,
                            t["canny_low"], t["canny_high"], quant,
                            qc_dtype)


def yardstick(ctx, images):
    """The reference's probabilities, and of the mirrored frames, with
    every convolution's operands rounded to bf16."""
    return ref.ensemble_probs(ctx.encoder, ctx.params,
                              [1.0] * len(ctx.params), images, bf16_round)


def judge(ctx, i, outputs, mirrored, ref_out, yard) -> dict:
    """Every number of batch i's host outputs (and of the probabilities
    of its mirrored frames, mirrored back) against the reference's."""
    pred_np, probs_np, stats_np = outputs
    dev, t = ctx.device, ctx.cell.traffic
    pred = torch.from_numpy(pred_np).to(dev).to(torch.bool)
    probs = torch.from_numpy(probs_np).to(dev)
    stats = {k: torch.from_numpy(v).to(dev) for k, v in stats_np.items()}
    return ref.gaps(ctx.pool[i], pred, probs, stats,
                    torch.from_numpy(mirrored).to(dev), *ref_out, *yard,
                    ctx.threshold, ctx.min_area, t["canny_low"],
                    t["canny_high"])


def _each(ctx):
    return [judge(ctx, i, outputs, mirrored,
                  reference_outputs(ctx, ctx.pool[i]),
                  yardstick(ctx, ctx.pool[i]))
            for (i, outputs), mirrored in zip(ctx.kept, ctx.mirrored)]


def readings(ctx) -> dict:
    """The worst reading of every number over the sampled batches."""
    return ref.worst(_each(ctx)) or {}


def check(ctx, limits: dict):
    """(the worst reading of each number held to `limits` over the
    sampled batches, the count of sampled batches that break a limit)."""
    each = [{k: r[k] for k in limits} for r in _each(ctx)]
    wrong = sum(any(r[k] > limits[k] for k in r) for r in each)
    return ref.worst(each) or {}, wrong
