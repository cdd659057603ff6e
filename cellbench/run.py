"""Run one cell of the port's benchmark once, on the card this process
sees, and print the result as the last line of standard output:

    python3 -m cellbench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). Exits
with 2 and prints no result where PyTorch sees no card, or fewer cards
than the cell asks for, and with 3 where the process holds a module of
the JAX stack or of the JAX package once the window has closed. The
numbers that decide `correct` are printed with their limits as the
last lines of standard error, and last in the result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cellbench import harness

    cell = harness.resolve(args.workload, ROOT)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cellbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", ROOT, T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"cellbench: the process holds {held}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
