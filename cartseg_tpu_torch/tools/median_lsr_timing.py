"""Check and time the port's exact median (`median_rows`) and LSR backward
(`lsr_bwd`) on the card, and the ABL train step that runs `lsr_bwd`, so
that two checkouts of the port can be compared on one card:

    python cartseg_tpu_torch/tools/median_lsr_timing.py [--root CHECKOUT]
    python cartseg_tpu_torch/tools/median_lsr_timing.py --parent OTHER
        [--root CHECKOUT]

The first form imports `cartseg_tpu_torch` from CHECKOUT (by default the
checkout that holds this file), builds its kernels, checks each call
against its plain version (the median bit for bit, twice; lsr_bwd within
2e-6 at a unit upstream gradient and 1e-5 at a random one), and prints
one JSON line with, for each input, the device ms a call (torch.profiler,
every kernel and memset of the call summed, the 50 MB L2 flushed before
each call; one call's host cost can exceed these kernels, so CUDA events
around a loop would time the host) and the CUDA-events ms a call (mean
over CALLS back-to-back calls after one warm-up call), and the CUDA
kernels a call. Inputs: the median on the pseudo-label path's
[64,262144] |p - 0.5| * 2 rows (p = sigmoid(3 z), z normal; skewed
toward 1); lsr_bwd on the ABL path's [6*512*512, 8] logits (3 z), labels
0..7 as int64 with every 7th row at the ignore index 255, and a normal
upstream gradient. The line also holds the ABL trainer's step
(`Trainer.train_step` at workloads/train_bce_dice_abl.py's CONFIG:
effnet-b0 UNet, bs6@512^2, bf16 autocast, BCE+Dice+ABL, AdamW) on a
device-resident synthetic batch: STEP_READINGS readings, each the mean
ms of STEP_CALLS steps by CUDA events after STEP_WARMUP warm-up steps.
That step is bound by the host (eager launches), so its readings spread
with the host's load. The second form runs the first for OTHER,
CHECKOUT, CHECKOUT, OTHER, one process each, and prints their lines and
then one line of the pairs' means beside each kernel input's bound: its
bytes (inputs read once, outputs written once) at 3.35 TB/s; for the
step, each side's mean and its readings' least and most.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B, N = 64, 512 * 512
ROWS, C = 6 * 512 * 512, 8
SEED, CALLS, COLD_CALLS = 0, 20, 20
STEP_WARMUP, STEP_CALLS, STEP_READINGS = 5, 20, 3
HBM_BYTES_PER_S = 3.35e12
# bytes: the rows read, the medians written; the logits, int64 labels
# and g read, the gradient written
BOUND_MS = {"median": (B * N * 4 + B * 4) / HBM_BYTES_PER_S * 1e3,
            "lsr_bwd": ROWS * (C * 4 + 8 + 4 + C * 4)
            / HBM_BYTES_PER_S * 1e3}
LSR_TOL = {"unit g": 2e-6, "random g": 1e-5}


def inputs(dev) -> dict:
    """name -> (call of the kernel's wrapper, call of its plain version,
    check of the two outputs)."""
    import torch

    from cartseg_tpu_torch.ops.cuda.lsr import lsr_bwd, lsr_bwd_plain
    from cartseg_tpu_torch.ops.cuda.median import (median_rows,
                                                   median_rows_plain)

    g = torch.Generator(device="cpu").manual_seed(SEED)
    conf = ((torch.sigmoid(3 * torch.randn((B, N), generator=g)) - 0.5)
            .abs() * 2.0).to(dev)
    x = (torch.randn((ROWS, C), generator=g) * 3).to(dev)
    lab = torch.randint(0, C, (ROWS,), generator=g)
    lab[::7] = 255
    lab = lab.to(dev)
    up = torch.randn((ROWS,), generator=g).to(dev)
    ones = torch.ones_like(up)

    def check_median(got, want):
        if not torch.equal(got, want):
            raise AssertionError("median: kernel != plain")

    def check_lsr(got, want):
        unit = (lsr_bwd(x, lab, ones, 0.2, 255),
                lsr_bwd_plain(x, lab, ones, 0.2, 255))
        for name, (a, b) in (("random g", (got, want)), ("unit g", unit)):
            err = float((a - b).abs().max())
            if not err <= LSR_TOL[name]:
                raise AssertionError(f"lsr_bwd, {name}: max abs err {err}"
                                     f" above {LSR_TOL[name]}")

    return {"median": (lambda: median_rows(conf),
                       lambda: median_rows_plain(conf), check_median),
            "lsr_bwd": (lambda: lsr_bwd(x, lab, up, 0.2, 255),
                        lambda: lsr_bwd_plain(x, lab, up, 0.2, 255),
                        check_lsr)}


def cold_device_ms(fn, calls: int = COLD_CALLS, tries: int = 6) -> tuple:
    """(device ms a call, {kernel: launches a call}) of fn over `calls`
    calls, each after a 256 MB buffer is zeroed (its fill kernel left
    out), from torch.profiler; a window that comes back without a kernel
    of fn is taken again, up to `tries` times (the profiler on these
    machines can drop a window's events)."""
    import torch

    from cartseg_tpu_torch.utils.profiling import device_kernels

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def call():
        flush.zero_()
        fn()

    call()
    for i in range(tries):
        time.sleep(0.5 * i)
        trace = {k: v for k, v in device_kernels(call, calls).items()
                 if "FillFunctor" not in k}
        if trace:
            break
    else:
        raise RuntimeError(f"the profiler recorded no kernel in {tries} "
                           "windows")
    ms = sum(us for _, us in trace.values()) / calls / 1e3
    per_call = {k.replace("(anonymous namespace)::", "").split("(")[0]
                .removeprefix("void "): c / calls
                for k, (c, _) in trace.items()}
    return ms, per_call


def events_ms(fn, calls: int = CALLS) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def abl_step_ms() -> list:
    """STEP_READINGS readings of the ABL train step's ms (CUDA events)."""
    import numpy as np
    import torch

    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame
    from cartseg_tpu_torch.workloads.train_bce_dice_abl import CONFIG

    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda"])
    bs, (h, w) = cfg.batch_size, cfg.img_size
    r = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([frame(r, (h, w))
                                      for _ in range(bs)])).cuda()
    masks = torch.from_numpy(blob_masks(r, (bs, h, w), n=3)[..., None]
                             .astype(np.float32)).cuda()
    sw = torch.ones(bs, device="cuda")
    tr = Trainer(cfg)
    st = tr.init_state()
    gids = tr.group_ids(st)

    def step():     # the learning rates and factors of the 3 groups
        tr.train_step(st, imgs, masks, sw, [1e-4] * 3, [1.0] * 3, gids)

    for _ in range(STEP_WARMUP):
        step()
    return [events_ms(step, STEP_CALLS) for _ in range(STEP_READINGS)]


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("median_lsr_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    row = {"root": str(root), "card": card[0] if card else "unknown"}
    for name, (kern, plain, check) in inputs(torch.device("cuda")).items():
        got = kern()
        check(got, plain())
        again = kern()
        torch.cuda.synchronize()
        if name == "median" and not torch.equal(again, got):
            raise AssertionError("median: two calls differ")
        row[f"{name}_device_ms"], row[f"{name}_kernels"] = \
            cold_device_ms(kern)
        row[f"{name}_events_ms"] = events_ms(kern)
    row["abl_step_ms"] = abl_step_ms()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.parent is None:
        print(json.dumps(measure(args.root)), flush=True)
        return 0
    rows = []
    for root in (args.parent, args.root, args.root, args.parent):
        res = subprocess.run([sys.executable, __file__, "--root", str(root)],
                             capture_output=True, text=True)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            print(res.stdout, end="")
            return res.returncode
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    keys = [f"{k}_{t}_ms" for k in BOUND_MS for t in ("device", "events")]

    def side(a, b):
        out = {k: (a[k] + b[k]) / 2 for k in keys}
        steps = a["abl_step_ms"] + b["abl_step_ms"]
        out["abl_step_ms"] = {"mean": sum(steps) / len(steps),
                              "least": min(steps), "most": max(steps)}
        return out

    print(json.dumps({"order": "parent change change parent",
                      "card": rows[0]["card"],
                      "parent": side(rows[0], rows[3]),
                      "change": side(rows[1], rows[2]),
                      "bound_ms": BOUND_MS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
