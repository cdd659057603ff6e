"""Check and time the port's CC labelling (`cc_batch`) and hysteresis
reach (`reach_batch`) on the card, so that two checkouts of the port can
be compared on one card:

    python cartseg_tpu_torch/tools/cc_timing.py [--root CHECKOUT]
    python cartseg_tpu_torch/tools/cc_timing.py --parent OTHER [--root C]

The first form imports `cartseg_tpu_torch` from CHECKOUT (by default the
checkout that holds this file), builds its kernels, checks each call bit
for bit against its plain version, and prints one JSON line: the mean ms
a call over CALLS calls, between CUDA events after one warm-up call, at
the pseudo-label path's [64,512,512] on four inputs: CC (8-connectivity)
on all-foreground masks (what the path's near-full masks from random
weights give), on blob masks (`utils/synthetic.blob_masks`, 8 discs an
image) and on chip_smoke.py's mixed masks (30 blob images, 30 of uniform
noise at p = 0.45, one empty, one full, a one-arm spiral, cut rings);
reach on the weak / strong maps of Canny (50 / 150) on 64 synthetic
400x512 frames letterboxed to 512^2; beside each, every CUDA kernel and
memset a call runs, with its launches and device ms a call
(torch.profiler over 10 calls). The second form runs the first for
OTHER, CHECKOUT, CHECKOUT, OTHER, one process each, and prints their
lines and then one line of the pairs' means beside each input's bound:
its bytes (the masks read once, the labels or flags written once) at
3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

B, S, SEED = 64, 512, 0
FRAME_HW = (512, 400)
CALLS = 20
HBM_BYTES_PER_S = 3.35e12
# bytes a pixel: the mask and the int32 label; weak, strong and the flag
BOUND_MS = {k: B * S * S * (5 if k.startswith("cc") else 3)
            / HBM_BYTES_PER_S * 1e3
            for k in ("cc_all_fg", "cc_blobs", "cc_mixed", "reach_canny")}


def mixed_masks(rng, b: int = B, s: int = S):
    """[b,s,s] bool (b = 64): blobs, noise at p = 0.45, all background,
    all foreground, a one-arm spiral and cut rings."""
    import numpy as np

    from cartseg_tpu_torch.utils.synthetic import (blob_masks,
                                                   ring_cuts_mask,
                                                   spiral_mask)

    m = np.zeros((b, s, s), bool)
    m[:30] = blob_masks(rng, (30, s, s), n=8)
    m[30:60] = rng.random((30, s, s)) < 0.45
    m[61] = True
    m[62] = spiral_mask(s)
    m[63] = ring_cuts_mask(s)
    return m


def inputs(dev) -> dict:
    """name -> (call of the kernel's wrapper, call of its plain version)."""
    import numpy as np
    import torch

    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.ops.cuda.cc import (cc_batch, cc_batch_plain,
                                               reach_batch,
                                               reach_batch_plain)
    from cartseg_tpu_torch.ops.edges import canny_weak_strong, rgb_to_gray
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame

    rng = np.random.default_rng(SEED)
    masks = {
        "cc_all_fg": torch.ones((B, S, S), dtype=torch.bool),
        "cc_blobs": torch.from_numpy(blob_masks(rng, (B, S, S), n=8)),
        "cc_mixed": torch.from_numpy(mixed_masks(rng)),
    }
    frames = np.stack([G.resize_square(G.letterbox_side_pad(
        frame(rng, FRAME_HW)), S) for _ in range(B)])
    weak, strong = canny_weak_strong(rgb_to_gray(
        torch.from_numpy(frames).to(dev)), 50.0, 150.0)
    out = {k: ((lambda m=m.to(dev): cc_batch(m)),
               (lambda m=m.to(dev): cc_batch_plain(m)))
           for k, m in masks.items()}
    out["reach_canny"] = (lambda: reach_batch(weak, strong),
                          lambda: reach_batch_plain(weak, strong))
    return out


def kernels_a_call(fn, calls: int = 10) -> dict:
    """{kernel: [launches, device ms] a call} from the profiler."""
    from cartseg_tpu_torch.utils.profiling import device_kernels

    out = {}
    for name, (c, us) in device_kernels(fn, calls).items():
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        short = short.removeprefix("void ")
        n, ms = out.get(short, (0, 0.0))
        out[short] = [n + c / calls, ms + us / calls / 1e3]
    return out


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cc_timing: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    row = {"root": str(root), "card": card[0] if card else "unknown"}
    for name, (kern, plain) in inputs(dev).items():
        got = kern()
        if not torch.equal(got, plain()):
            raise AssertionError(f"{name}: kernel != plain")
        if not torch.equal(kern(), got):
            raise AssertionError(f"{name}: two calls differ")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(CALLS):
            kern()
        end.record()
        torch.cuda.synchronize()
        row[name] = start.elapsed_time(end) / CALLS
        row[f"{name}_kernels"] = kernels_a_call(kern)
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
    keys = [k for k in rows[0] if k in BOUND_MS]
    print(json.dumps({"order": "parent change change parent",
                      "card": rows[0]["card"],
                      "parent": {k: (rows[0][k] + rows[3][k]) / 2
                                 for k in keys},
                      "change": {k: (rows[1][k] + rows[2][k]) / 2
                                 for k in keys},
                      "bound_ms": BOUND_MS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
