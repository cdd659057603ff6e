"""Time the port's jump-flood EDT (`edt_batch_jfa`) on the card, so that
two checkouts of the port can be compared on one card:

    python cartseg_tpu_torch/tools/edt_timing.py [--root CHECKOUT]

imports `cartseg_tpu_torch` from CHECKOUT (by default the checkout that
holds this file), builds its EDT kernels, checks a call bit for bit
against its `edt_batch_plain`, and prints one JSON line: at the largest
side the wrapper takes, [1,2048,2048], and at the path's [6,512,512],
the mean ms a call over CALLS calls, between CUDA events after one
warm-up call. The seeds are 1 % of the pixels at random: 1+JFA runs
every step and candidate whatever the seeds, so the work does not
depend on them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SHAPES = ((1, 2048, 2048), (6, 512, 512))
CALLS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import numpy as np
    import torch

    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain

    if not torch.cuda.is_available():
        print("edt_timing: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    rows = []
    for shape in SHAPES:
        seeds = torch.from_numpy(rng.random(shape) < 0.01).cuda()
        got = edt_batch_jfa(seeds)
        if not torch.equal(got, edt_batch_plain(seeds)):
            raise AssertionError(f"edt {shape}: kernel != plain")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(CALLS):
            edt_batch_jfa(seeds)
        end.record()
        torch.cuda.synchronize()
        rows.append({"shape": list(shape),
                     "ms": start.elapsed_time(end) / CALLS})
    print(json.dumps({"root": str(args.root), "edt": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
