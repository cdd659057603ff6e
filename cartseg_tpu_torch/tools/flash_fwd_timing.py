"""Check and time the port's flash-attention forward kernel on the card,
so that two checkouts of the port can be compared on one card:

    python cartseg_tpu_torch/tools/flash_fwd_timing.py [--root CHECKOUT]
        [--dtype float32|bfloat16] [--reps N]

imports `cartseg_tpu_torch` from CHECKOUT (by default the checkout that
holds this file), builds its kernels, prints the compiler's registers,
spills and shared memory of the forward kernels (-Xptxas -v), counts the
SASS instructions of the route's kernel at SAM's shape (head_dim 64,
g = 64) by opcode (cuobjdump -sass: one tile's loop body counts once),
holds the output and the training call's lse against
`flash_relpos_fwd_lse_plain` at CASES (max abs error over the plain
value's max |value|: out 1e-5 in float32 and 1e-2 in bfloat16, lse 1e-5
relative; the same bits on a second call and out equal to the inference
call's), and prints one JSON line: at the ViT-B global block [12,4096,64]
(q, k, v ~ N(0,1), the rel factors 0.5 N(0,1), seeded), the mean ms a call
over `--reps` calls between CUDA events after one warm-up call, of the
inference call, of the training call (with lse) and of
F.scaled_dot_product_attention with the (bnh,S,S) bias built beforehand,
in the order fwd, fwd_lse, sdpa, sdpa, fwd_lse, fwd.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from flash_bwd_timing import sass_mix

# (bnh, g, head_dim): the ViT-B global block, the tests' size, a ragged
# grid, head_dim 32 at g = 64, a grid of 10, the largest grid
CASES = ((12, 64, 64), (2, 16, 32), (1, 23, 32), (2, 64, 32), (2, 10, 64),
         (1, 128, 64))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the route's kernel at SAM's shape by its mangled name: the split-TF32
# kernel, the CUDA-core kernel it replaced, the bf16 tensor-core kernel
SASS_KERNELS = {"float32": ("flash_fwd_tf32x3ILi64ELb1E",
                            "flash_relpos_fwdILi64EE"),
                "bfloat16": ("flash_fwd_tcILi64ELb1E",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--dtype", choices=tuple(TOL), default="float32")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    import torch.nn.functional as F

    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_relpos_fwd, flash_relpos_fwd_lse_plain)

    if not torch.cuda.is_available():
        print("flash_fwd_timing: no CUDA device", file=sys.stderr)
        return 1
    dt = getattr(torch, args.dtype)
    build.load_library()
    mix = sass_mix(build.library_path(), build._nvcc(),
                   SASS_KERNELS[args.dtype])
    show = False
    for line in build.BUILD_LOG["text"].splitlines():
        if "Compiling entry function" in line:
            show = "fwd" in line
        if show:
            print(line.strip())

    def inputs(bnh, g, hd):
        gen = torch.Generator(device="cpu").manual_seed(0)
        S = g * g
        ts = [torch.randn((bnh, S, hd), generator=gen) for _ in range(3)]
        ts += [0.5 * torch.randn((bnh, S, g), generator=gen)
               for _ in range(2)]
        return [t.to(dt).cuda() for t in ts]

    errs = {}
    for bnh, g, hd in CASES:
        ts = inputs(bnh, g, hd)
        scale = hd ** -0.5
        out = flash_relpos_fwd(*ts, scale, g)
        out2, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
        out3, lse3 = flash_relpos_fwd(*ts, scale, g, with_lse=True)
        torch.cuda.synchronize()
        want, lse_want = flash_relpos_fwd_lse_plain(*ts, scale, g)
        rel = {"out": float((out.float() - want.float()).abs().max()
                            / want.float().abs().max()),
               "lse": float((lse - lse_want).abs().max()
                            / lse_want.abs().max())}
        same = (torch.equal(out, out2) and torch.equal(out2, out3)
                and torch.equal(lse, lse3))
        errs[f"{bnh},{g * g},{hd}"] = rel
        if not same or rel["out"] > TOL[args.dtype] or rel["lse"] > 1e-5:
            raise AssertionError(f"[{bnh},{g * g},{hd}] {args.dtype}: max "
                                 f"abs err over max |plain| {rel} (tolerance"
                                 f" {TOL[args.dtype]}, lse 1e-5); same bits "
                                 f"{same}")
        del ts, out, out2, out3, want, lse, lse3, lse_want

    bnh, g, hd = CASES[0]
    ts = inputs(bnh, g, hd)
    S, scale = g * g, hd ** -0.5
    bias = (ts[3][:, :, :, None] + ts[4][:, :, None, :]).reshape(bnh, S, S)

    def ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    fns = {"fwd": lambda: flash_relpos_fwd(*ts, scale, g),
           "fwd_lse": lambda: flash_relpos_fwd(*ts, scale, g, with_lse=True),
           "sdpa": lambda: F.scaled_dot_product_attention(
               ts[0], ts[1], ts[2], attn_mask=bias, scale=scale)}
    order = ("fwd", "fwd_lse", "sdpa", "sdpa", "fwd_lse", "fwd")
    times = {}
    for name in order:
        times.setdefault(name, []).append(ms(fns[name]))
    print(json.dumps({"root": str(args.root), "dtype": args.dtype,
                      "shape": [bnh, S, hd], "ms": times,
                      "max_rel_err": errs, "sass": mix,
                      "card": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
