"""Check and time the port's per-channel sums (`channel_sums`) and LSR
forward (`lsr_fwd`) on the card, and the BCE+Dice train step whose
kernel lane runs `channel_sums`, so that two checkouts of the port can be
compared on one card:

    python cartseg_tpu_torch/tools/sums_lsr_timing.py [--root CHECKOUT]
    python cartseg_tpu_torch/tools/sums_lsr_timing.py --parent OTHER
        [--root CHECKOUT]

The first form imports `cartseg_tpu_torch` from CHECKOUT (by default the
checkout that holds this file), builds its kernels, checks each call
against its plain version and prints one JSON line with, for each input,
the device ms a call (torch.profiler, every kernel of the call summed),
the CUDA-events ms a call (mean over CALLS back-to-back calls after one
warm-up call) and the CUDA kernels and memsets a call (a CUDA graph of
the call). Inputs:
  * `lsr_fwd` on the ABL path's [6*512*512, 8] logits (3 z), labels 0..7
    with every 7th row at the ignore index 255, as int64 (the path's
    type) and as int32; within 1e-5 of `lsr_fwd_plain`; the 50 MB L2
    flushed before each timed call;
  * `channel_sums` on the 92 BN inputs of one resnet34-UNet bs6@512^2
    bf16 `channels_last` train step (workloads/train_bce_dice.py's
    CONFIG, the kernel lane), captured by forward pre-hooks on one step
    with a seeded batch, each BN's (x, x) and (dy, x) with a normal dy:
    each call within 1e-5 of the per-channel sum of |.| against
    `channel_sums_plain` and the same bits on a second call; the 92 calls
    timed back to back as one call (as chip_smoke.py phase 5 does), and
    the decoder top's (x, x) and (dy, x) alone, with the L2 flushed
    (a 256 MB buffer zeroed, which leaves the L2 full of dirty lines)
    and back to back;
  * the BCE+Dice step in the kernel lane on the same batch: STEP_READINGS
    readings, each the mean ms of STEP_CALLS steps by CUDA events after
    STEP_WARMUP warm-up steps. The step is bound by the host (eager
    launches), so its readings spread with the host's load.
The second form runs the first for OTHER, CHECKOUT, CHECKOUT, OTHER, one
process each, prints their lines and then one line of the pairs' means
beside each kernel input's bound (its bytes, inputs read once and outputs
written once, at 3.35 TB/s) and, for the step, each side's mean and its
readings' least and most.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROWS, C = 6 * 512 * 512, 8
SEED, CALLS, COLD_CALLS = 0, 20, 20
STEP_WARMUP, STEP_CALLS, STEP_READINGS = 5, 20, 3
HBM_BYTES_PER_S = 3.35e12
LSR_TOL, SUMS_TOL = 1e-5, 1e-5
BN_LAYERS = 46


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def device_ms(fn, calls: int, cold: bool, tries: int = 6) -> float:
    """Device ms a call of fn over `calls` calls from torch.profiler, every
    kernel of the call summed; cold: a 256 MB buffer zeroed before each
    call (its fill kernel left out). A window that comes back without a
    kernel of fn is taken again, up to `tries` times (the profiler on
    these machines can drop a window's events)."""
    import torch

    from cartseg_tpu_torch.utils.profiling import device_kernels

    call = fn
    if cold:
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

        def call():
            flush.zero_()
            fn()

    call()
    for i in range(tries):
        time.sleep(0.5 * i)
        trace = {k: v for k, v in device_kernels(call, calls).items()
                 if not (cold and "FillFunctor" in k)}
        if trace:
            break
    else:
        raise RuntimeError(f"the profiler recorded no kernel in {tries} "
                           "windows")
    return sum(us for _, us in trace.values()) / calls / 1e3


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


def graph_counts(fn) -> dict:
    """{kind: count} of the operations one call of fn enqueues (a CUDA
    graph of the call: KERNEL, MEMSET, MEMCPY)."""
    from cartseg_tpu_torch.utils.profiling import graph_nodes

    fn()
    out = {}
    for kind, _ in graph_nodes(fn):
        out[kind] = out.get(kind, 0) + 1
    return out


def bce_setup():
    """The kernel-lane BCE+Dice trainer at its CONFIG on a seeded
    device-resident batch, its step, and the 92 channel_sums inputs of
    one step: [((a, b), label)] in call order."""
    import numpy as np
    import torch

    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame
    from cartseg_tpu_torch.workloads.train_bce_dice import CONFIG

    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda"])
    bs, (h, w) = cfg.batch_size, cfg.img_size
    r = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([frame(r, (h, w))
                                      for _ in range(bs)])).cuda()
    masks = torch.from_numpy(blob_masks(r, (bs, h, w), n=3)[..., None]
                             .astype(np.float32)).cuda()
    sw = torch.ones(bs, device="cuda")
    tr = Trainer(cfg, bn_lane="channel_sums")
    st = tr.init_state()
    gids = tr.group_ids(st)

    def step():     # the learning rates and factors of the 3 groups
        tr.train_step(st, imgs, masks, sw, [1e-4] * 3, [1.0] * 3, gids)

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
        for m in st.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        step()
    finally:
        for hk in hooks:
            hk.remove()
    if len(seen) != BN_LAYERS:
        raise AssertionError(f"{len(seen)} BN inputs captured, want "
                             f"{BN_LAYERS}")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    calls = []
    for i, x in enumerate(seen):
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"BN input {i} {tuple(x.shape)} is not "
                                 "channels_last")
        dy = torch.randn(x.shape, generator=gen).to(x.dtype).cuda() \
            .contiguous(memory_format=torch.channels_last)
        calls.append(((x, x), f"{i} (x, x)"))
        calls.append(((dy, x), f"{i} (dy, x)"))
    return step, calls


def check_sums(calls) -> float:
    """Each call within SUMS_TOL of the per-channel sum of |.| against the
    plain version and the same bits twice; returns the largest error as
    a share of that sum."""
    import torch

    from cartseg_tpu_torch.ops.channel_sums import (channel_sums,
                                                    channel_sums_plain)

    worst = 0.0
    for (a, b), label in calls:
        got, again = channel_sums(a, b), channel_sums(a, b)
        want = channel_sums_plain(a, b)
        torch.cuda.synchronize()
        af, bf = a.float(), b.float()
        scale = (af.abs().sum((0, 2, 3)), (af * bf).abs().sum((0, 2, 3)))
        for g, h, w, sc in zip(got, again, want, scale):
            share = float(((g - w).abs() / sc.clamp_min(1e-30)).max())
            worst = max(worst, share)
            if not share <= SUMS_TOL or not torch.equal(g, h):
                raise AssertionError(
                    f"channel_sums {label} {tuple(a.shape)}: error "
                    f"{share:.3e} of the sum of |.|, same bits twice "
                    f"{torch.equal(g, h)}")
    return worst


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sums_lsr_timing: no CUDA device")
    from cartseg_tpu_torch.ops.channel_sums import channel_sums
    from cartseg_tpu_torch.ops.cuda.lsr import lsr_fwd, lsr_fwd_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    row = {"root": str(root), "card": card[0] if card else "unknown"}
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x = (torch.randn((ROWS, C), generator=g) * 3).cuda()
    lab = torch.randint(0, C, (ROWS,), generator=g)
    lab[::7] = 255
    lab = lab.cuda()
    for name, lb in (("lsr_fwd_int64", lab),
                     ("lsr_fwd_int32", lab.to(torch.int32))):
        def call(lb=lb):
            return lsr_fwd(x, lb, 0.2, 255)

        err = float((call() - lsr_fwd_plain(x, lb, 0.2, 255)).abs().max())
        if not err <= LSR_TOL:
            raise AssertionError(f"{name}: max abs err {err} above "
                                 f"{LSR_TOL}")
        row[f"{name}_max_abs_err"] = err
        row[f"{name}_device_ms"] = device_ms(call, COLD_CALLS, cold=True)
        row[f"{name}_events_ms"] = events_ms(call)
        row[f"{name}_graph"] = graph_counts(call)
        row[f"{name}_bound_ms"] = bound_ms(nbytes(x, lb) + ROWS * 4)
    del x, lab

    step, calls = bce_setup()
    row["sums_max_err_share"] = check_sums(calls)

    def all_calls():
        for (a, b), _ in calls:
            channel_sums(a, b)

    row["sums_92_device_ms"] = device_ms(all_calls, 3, cold=False)
    row["sums_92_events_ms"] = events_ms(all_calls, 5)
    row["sums_92_graph"] = graph_counts(all_calls)
    row["sums_92_bound_ms"] = sum(
        bound_ms(nbytes(a) + (0 if a is b else nbytes(b))
                 + 2 * a.shape[1] * 4) for (a, b), _ in calls)
    for what, ((a, b), _) in (("xx", calls[-2]), ("dyx", calls[-1])):
        def call(a=a, b=b):
            return channel_sums(a, b)

        row[f"sums_top_{what}_device_ms"] = device_ms(call, COLD_CALLS,
                                                      cold=True)
        row[f"sums_top_{what}_warm_ms"] = device_ms(call, COLD_CALLS,
                                                    cold=False)
        row[f"sums_top_{what}_graph"] = graph_counts(call)
        row[f"sums_top_{what}_bound_ms"] = bound_ms(
            nbytes(a) + (0 if a is b else nbytes(b)) + 2 * a.shape[1] * 4)
    row["sums_top_shape"] = list(calls[-1][0][0].shape)
    del calls
    for _ in range(STEP_WARMUP):
        step()
    row["bce_step_ms"] = [events_ms(step, STEP_CALLS)
                          for _ in range(STEP_READINGS)]
    return row


TIMED = ("lsr_fwd_int64", "lsr_fwd_int32", "sums_92", "sums_top_xx",
         "sums_top_dyx")


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

    def side(a, b):
        out = {f"{k}_{t}_ms": (a[f"{k}_{t}_ms"] + b[f"{k}_{t}_ms"]) / 2
               for k in TIMED for t in ("device", "warm", "events")
               if f"{k}_{t}_ms" in a}
        steps = a["bce_step_ms"] + b["bce_step_ms"]
        out["bce_step_ms"] = {"mean": sum(steps) / len(steps),
                              "least": min(steps), "most": max(steps),
                              "spread": (max(steps) - min(steps))
                              / min(steps)}
        return out

    print(json.dumps({"order": "parent change change parent",
                      "card": rows[0]["card"],
                      "parent": side(rows[0], rows[3]),
                      "change": side(rows[1], rows[2]),
                      "bound_ms": {k: rows[1][f"{k}_bound_ms"]
                                   for k in TIMED}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
