"""Check and time the port's flash-attention backward kernels
(`flash_bwd_dq`, `flash_bwd_dkv`) on the card, so that two checkouts of
the port can be compared on one card:

    python cartseg_tpu_torch/tools/flash_bwd_timing.py [--root CHECKOUT]
        [--dtype float32|bfloat16] [--reps N]

imports `cartseg_tpu_torch` from CHECKOUT (by default the checkout that
holds this file), builds its kernels, prints the compiler's registers,
spills and shared memory of the backward kernels (-Xptxas -v), counts the
SASS instructions of the route's two kernels at SAM's shape by opcode
(cuobjdump -sass: one tile's loop body counts once), holds the
five gradients against `flash_relpos_bwd_plain` at CASES (max abs error
over the plain gradient's max |value|, 1e-5 in float32 and 1e-2 in
bfloat16, and the same bits on a second call), and prints one JSON line:
at the ViT-B global block [12,4096,64] (q, k, v ~ N(0,1), the rel factors
0.5 N(0,1), dO ~ N(0,1), seeded), the mean ms a call of each kernel over
`--reps` calls between CUDA events after one warm-up call, of each kernel
and of autograd of F.scaled_dot_product_attention with the (bnh,S,S) bias
built and requiring grad, plus the two sums of dbias into drel_h and
drel_w, in the order dq, dkv, SDPA, SDPA, dkv, dq.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

# (bnh, g, head_dim): the ViT-B global block, the tests' size, a ragged
# grid, head_dim 32 at g = 64
CASES = ((12, 64, 64), (2, 16, 32), (1, 23, 32), (2, 64, 32))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NAMES = ("dq", "dk", "dv", "drel_h", "drel_w")
# the kernels whose SASS instruction mix is counted: the routes' kernels
# at SAM's shape (head_dim 64, g = 64), by their mangled names
SASS_KERNELS = {"float32": ("flash_bwd_dq_tf32x3ILi64ELb1E",
                            "flash_bwd_dkv_tf32x3ILi64ELb1E"),
                "bfloat16": ("flash_bwd_dq_tcILi64ELb1E",
                             "flash_bwd_dkv_tcILi64ELb1E")}


def opcode_counts(sass: str, key) -> dict:
    """{key(function): {opcode: count}} of a cuobjdump -sass listing, over
    the functions for which key(name) is not None: the code of one call,
    so a loop body counts once."""
    mix, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = key(line.split("Function :", 1)[1].strip())
            if cur is not None:
                mix[cur] = collections.Counter()
        elif cur is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)", line)
            if m:
                mix[cur][m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in mix.items()}


def sass_mix(library: Path, nvcc: str, names) -> dict:
    """{kernel: {opcode: count}} of the SASS instructions (cuobjdump
    -sass, beside nvcc) of the kernels whose mangled names hold one of
    `names`, keyed by that name."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True,
                          check=True).stdout
    return opcode_counts(text, lambda fn: next(
        (n for n in names if n in fn), None))


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
        flash_bwd_dkv, flash_bwd_dq, flash_relpos_bwd_plain,
        flash_relpos_fwd, row_delta)

    if not torch.cuda.is_available():
        print("flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    dt = getattr(torch, args.dtype)
    build.load_library()
    mix = sass_mix(build.library_path(), build._nvcc(),
                   SASS_KERNELS[args.dtype])
    show = False
    for line in build.BUILD_LOG["text"].splitlines():
        if "Compiling entry function" in line:
            show = "flash_bwd" in line
        if show:
            print(line.strip())

    def inputs(bnh, g, hd):
        gen = torch.Generator(device="cpu").manual_seed(0)
        S = g * g
        ts = [torch.randn((bnh, S, hd), generator=gen) for _ in range(3)]
        ts += [0.5 * torch.randn((bnh, S, g), generator=gen)
               for _ in range(2)]
        do = torch.randn((bnh, S, hd), generator=gen)
        return [t.to(dt).cuda() for t in ts], do.to(dt).cuda()

    errs = {}
    for bnh, g, hd in CASES:
        ts, do = inputs(bnh, g, hd)
        scale = hd ** -0.5
        out, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
        args_ = (*ts, do, lse, row_delta(out, do), scale, g)
        got = (*flash_bwd_dq(*args_), *flash_bwd_dkv(*args_))
        again = (*flash_bwd_dq(*args_), *flash_bwd_dkv(*args_))
        torch.cuda.synchronize()
        dq, drh, drw, dk, dv = got
        want = flash_relpos_bwd_plain(*ts, out, lse, do, scale, g)
        rel = {n: float((a.float() - b.float()).abs().max()
                        / b.float().abs().max())
               for n, a, b in zip(NAMES, (dq, dk, dv, drh, drw), want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs[f"{bnh},{g * g},{hd}"] = rel
        if not same or max(rel.values()) > TOL[args.dtype]:
            raise AssertionError(f"[{bnh},{g * g},{hd}] {args.dtype}: max "
                                 f"abs err over max |plain| {rel} (tolerance"
                                 f" {TOL[args.dtype]}); same bits twice "
                                 f"{same}")

    bnh, g, hd = CASES[0]
    ts, do = inputs(bnh, g, hd)
    S, scale = g * g, hd ** -0.5
    out, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
    args_ = (*ts, do, lse, row_delta(out, do), scale, g)
    lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in ts[:3])
    bias = (ts[3][:, :, :, None] + ts[4][:, :, None, :]).reshape(
        bnh, S, S).requires_grad_(True)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias,
                                        scale=scale)

    def lib():
        gq, gk, gv, gb = torch.autograd.grad(lo, (lq, lk, lv, bias), do,
                                             retain_graph=True)
        gb = gb.reshape(bnh, S, g, g)
        return gq, gk, gv, gb.sum(-1), gb.sum(-2)

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

    fns = {"dq": lambda: flash_bwd_dq(*args_),
           "dkv": lambda: flash_bwd_dkv(*args_), "sdpa_autograd": lib}
    order = ("dq", "dkv", "sdpa_autograd", "sdpa_autograd", "dkv", "dq")
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
