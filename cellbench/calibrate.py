"""The readings a cell's check limits are set from, in one process:

    python3 -m cellbench.calibrate --workload <name> --seeds a,b,... \
        [--control-seeds x,y,z] [--faults name:seed,seed ...] \
        [--seconds 2] [--out calibrate.jsonl]

For each of --seeds, the program as the benchmark runs it (set-up, a
short window at the cell's own load, the check): its numbers are the
lower readings. For each of --control-seeds, the control: the plain
reference in the program's place, its convolutions' operands rounded to
fp8 (the precision below the configuration's bf16) and its QC
statistics computed in bf16 (below their float32), judged as the
program is. For each --faults entry, the program with that fault planted
(cellbench/faults.py). One JSON line a reading goes to --out and to
standard output. It runs on the card the process sees; the benchmark's
own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cellbench import faults, harness
from cellbench.reference.unet import fp8_grad_round, fp8_round


def _program(cell, seed, seconds, device, hook=None):
    """Every number the check can hold, of the program's run at `seed`."""
    ctx = cell.driver.setup(cell, seed, device, lambda m: None, hook)
    cell.driver.window(ctx, seconds)
    cell.driver.release(ctx)
    if ctx.kind == "train":
        return ctx, cell.driver.readings(ctx, ctx.program_steps,
                                         cell.driver.reference_steps(ctx))
    return ctx, cell.driver.readings(ctx)


def _control(cell, seed, seconds, device):
    """The reference at fp8 judged as the program is, on the inputs the
    program's run at this seed would see."""
    ctx = cell.driver.setup(cell, seed, device, lambda m: None)
    cell.driver.window(ctx, seconds)
    cell.driver.release(ctx)
    if ctx.kind == "pseudo_label":
        from cellbench.reference import pseudo_label as ref
        readings = []
        for i, _ in ctx.kept:
            images = ctx.pool[i]
            pred, probs, stats, _ = cell.driver.reference_outputs(
                ctx, images, fp8_round, torch.bfloat16)
            host = (pred.cpu().numpy(), probs.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in stats.items()})
            # the control's own call on the mirrored frames
            mirrored = cell.driver.reference_outputs(
                ctx, images.flip(2), fp8_round, torch.bfloat16)[1].flip(-1)
            readings.append(cell.driver.judge(
                ctx, i, host, mirrored.cpu().numpy(),
                cell.driver.reference_outputs(ctx, images),
                cell.driver.yardstick(ctx, images)))
        return ref.worst(readings)
    from cellbench.reference import train as ref
    control = cell.driver.reference_steps(ctx, fp8_round, fp8_grad_round)
    reference = cell.driver.reference_steps(ctx)
    out = ref.gaps(control, reference, ctx.params)
    if ctx.program_steps.get("logits") is not None:
        # the ABL stage's control: this ABL in bf16 on the program's logits
        logits = ctx.program_steps["logits"]
        full, used = ref.abl(logits, (reference["first_masks"][..., 0]
                                      > 0.5).to(torch.int64))
        out["abl_stage_gap"] = ref.abl_stage_gap(
            logits, reference["first_masks"], float(full) if used else 0.0,
            torch.bfloat16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cell = harness.resolve(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        emit("program", seed, _program(cell, seed, args.seconds, device)[1],
             t0)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        emit("control", seed, _control(cell, seed, args.seconds, device), t0)
    for spec in args.faults:
        name, _, seed_list = spec.partition(":")
        for seed in [int(s) for s in seed_list.split(",") if s]:
            t0 = time.perf_counter()
            numbers = _program(cell, seed, args.seconds, device,
                               lambda ctx: faults.plant(ctx, name))[1]
            emit(f"fault:{name}", seed, numbers, t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
