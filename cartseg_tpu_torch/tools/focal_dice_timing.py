"""Check and time the port's focal loss (`focal_fwd`) and soft-Dice sums
(`soft_dice_sums`) kernels on the card, and count the focal kernel's SASS
instructions an element, so that two checkouts of the port can be
compared on one card:

    python cartseg_tpu_torch/tools/focal_dice_timing.py [--root CHECKOUT]
    python cartseg_tpu_torch/tools/focal_dice_timing.py --parent OTHER
        [--root CHECKOUT]

The first form imports `cartseg_tpu_torch` from CHECKOUT (by default the
checkout that holds this file), builds its kernels and prints one JSON
line. For each input: the largest error against the plain version
(focal: max abs error over the plain output's max |value|, within
ELEM_TOL; soft-Dice: the largest relative error a sample, within
DICE_TOL, and the same bits on a second call), the device ms a call
(torch.profiler, every kernel of the call summed) with the 50 MB L2
flushed before each call (a 256 MB buffer zeroed) and back to back, the
CUDA-events ms a call back to back, the CUDA kernels and memsets one call
enqueues (a CUDA graph of the call) and the bound (inputs read once and
outputs written once at 3.35 TB/s). Inputs, at the loss zoo's path
shapes (chip_smoke.py FOCAL_SHAPES, DICE_SHAPE): focal at
[6,512,512,1] and [20,224,224,1] with gamma 2 (the default) and at
[6,512,512,1] with gamma 1 and 1.5 (the other routes), logits 3 N(0,1)
and {0,1} targets, seeded; soft-Dice at [6,262144] with p = 1, 2 and
1.5, logits 2 N(0,1) + 1.5 (2 m - 1) over blob masks m, the last sample
without foreground. Beside them, ATen moving the same bytes under the
same flush, a yardstick of what a cold call can reach: x and y copied
into two outputs at each focal shape (`aten_copy_*`, 16 bytes an
element), and one sum over x and y laid end to end (`aten_sum_dice`).

Beside them, the focal kernel's SASS, read with cuobjdump -sass (beside
nvcc; the tool raises without it): the static instructions of each of
the library's `focal_fwd_bwd` kernels, and the instructions an element
of each exponent route: the checkout's element function (`focal`,
csrc/focal.cu) compiled with the build's flags into a probe kernel that
runs it on one element a thread, less the same probe that copies the
element, counted up to the function's first EXIT (the path an element
takes; the division's slow path lies past it) and in all. From the path
count, the issue time it implies at each focal shape: the warp
instructions (elements / 32 x count) over the card's SMs, 4 schedulers
an SM at one instruction a clock each, at the maximum SM clock
(nvidia-smi).

The second form runs the first for OTHER, CHECKOUT, CHECKOUT, OTHER, one
process each, prints their lines and then one line of the pairs' means
beside each input's bound, and each side's SASS counts.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from flash_bwd_timing import opcode_counts
from sums_lsr_timing import bound_ms, device_ms, events_ms, graph_counts

SEED, CALLS = 0, 20
FOCAL_SHAPES = ((6, 512, 512, 1), (20, 224, 224, 1))
DICE_SHAPE = (6, 512 * 512)
ELEM_TOL, DICE_TOL = 2e-6, 1e-6
# (label, shape index, gamma) of the focal inputs; the soft-Dice exponents
FOCAL_CASES = (("focal_g2_6x512", 0, 2.0), ("focal_g2_20x224", 1, 2.0),
               ("focal_g1_6x512", 0, 1.0), ("focal_g1.5_6x512", 0, 1.5))
DICE_CASES = (("dice_p1", 1.0), ("dice_p2", 2.0), ("dice_p1.5", 1.5))
SCHEDULERS_PER_SM = 4


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()
    return float(out[0]) * 1e6


def cuobjdump(build) -> Path:
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool}): the "
                           "SASS count needs it")
    return tool


def instructions(sass: str, name_part: str) -> dict:
    """{function: (instructions up to and with the first unpredicated
    EXIT, all instructions)} of a cuobjdump -sass listing, over the
    functions whose name holds name_part; NOPs and the closing branch to
    itself left out."""
    out, cur, label = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            cur = fn if name_part in fn else None
            if cur is not None:
                out[cur] = [0, 0, False]
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            label = lab.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if cur is None or not m:
            continue
        pred, op, args = m.group(1), m.group(2).split(".")[0], m.group(3)
        self_branch = op == "BRA" and label and f"({label})" in args
        label = None
        if op == "NOP" or self_branch:
            continue
        c = out[cur]
        c[1] += 1
        if not c[2]:
            c[0] += 1
            c[2] = op == "EXIT" and not pred
    return {fn: (p, t) for fn, (p, t, _) in out.items()}


def probe_sass(root: Path, build) -> tuple:
    """(routes, SASS listing) of the probe kernels: the focal element
    function as the checkout's csrc/focal.cu defines it, one element a
    thread, on each exponent route, and the copy it is measured against."""
    src = root / "cartseg_tpu_torch" / "ops" / "cuda" / "csrc" / "focal.cu"
    text = src.read_text()
    routes = ({"gamma2": "focal<2>", "gamma1": "focal<1>",
               "other": "focal<0>"}
              if re.search(r"template <int G>\s*__device__", text)
              else {"all": "focal"})
    args = ("(const float* x, const float* y, float* l, float* g, "
            "float gamma, float alpha)")
    body = "const int i = blockIdx.x * blockDim.x + threadIdx.x;"
    probe = [f'#include "{src}"',
             f'extern "C" __global__ void probe_copy{args} '
             f'{{ {body} l[i] = x[i]; g[i] = y[i]; }}']
    for name, fn in routes.items():
        probe.append(f'extern "C" __global__ void probe_{name}{args} '
                     f'{{ {body} {fn}(x[i], y[i], gamma, alpha, l[i], '
                     f'g[i]); }}')
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as td:
        cu, cubin = Path(td) / "probe.cu", Path(td) / "probe.cubin"
        cu.write_text("\n".join(probe) + "\n")
        subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(cu)], check=True, capture_output=True, text=True)
        sass = subprocess.run([str(cuobjdump(build)), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    return routes, sass


def element_counts(root: Path, build) -> dict:
    """{route: {"path": n, "all": n}} of the focal element function, by
    the probe: each route's probe less the copy."""
    routes, sass = probe_sass(root, build)
    counts = instructions(sass, "probe_")
    base = counts["probe_copy"]
    return {name: {"path": counts[f"probe_{name}"][0] - base[0],
                   "all": counts[f"probe_{name}"][1] - base[1]}
            for name in routes}


def sass_report(root: Path, build, library: Path, sms: int) -> dict:
    text = subprocess.run([str(cuobjdump(build)), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    kernels = {fn: {"path": p, "all": t}
               for fn, (p, t) in instructions(text, "focal_fwd_bwd").items()}
    elem = element_counts(root, build)
    clock = sm_clock_hz()
    issue = {}
    for name, c in elem.items():
        for shape in FOCAL_SHAPES:
            n = 1
            for d in shape:
                n *= d
            warps = n / 32 * c["path"]
            issue[f"{name} {list(shape)}"] = (
                warps / (sms * SCHEDULERS_PER_SM * clock) * 1e3)
    return {"kernels": kernels, "per_element": elem, "issue_ms": issue,
            "sm_clock_hz": clock,
            "mix": opcode_counts(text, lambda fn: fn if "focal_fwd_bwd" in fn
                                 else None)}


def focal_inputs(shape, seed):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 3
    y = (torch.rand(shape, generator=gen) > 0.5).float()
    return x.cuda(), y.cuda()


def dice_inputs():
    import numpy as np
    import torch

    from cartseg_tpu_torch.utils.synthetic import blob_masks

    B, M = DICE_SHAPE
    m = blob_masks(np.random.default_rng(SEED), (B, 512, 512), n=3)
    m = torch.from_numpy(m.reshape(B, M).astype(np.float32))
    m[-1] = 0.0
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randn(m.shape, generator=gen) * 2 + (2 * m - 1) * 1.5
    return x.cuda(), m.cuda()


def timed(row: dict, label: str, call, n_bytes: int) -> None:
    row[f"{label}_device_ms"] = device_ms(call, CALLS, cold=True)
    row[f"{label}_warm_ms"] = device_ms(call, CALLS, cold=False)
    row[f"{label}_events_ms"] = events_ms(call, CALLS)
    row[f"{label}_graph"] = graph_counts(call)
    row[f"{label}_bound_ms"] = bound_ms(n_bytes)


def measure(root: Path) -> dict:
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("focal_dice_timing: no CUDA device")
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.focal import focal_fwd, focal_plain
    from cartseg_tpu_torch.ops.cuda.soft_dice import (soft_dice_sums,
                                                      soft_dice_sums_plain)

    build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"root": str(root), "card": card(),
           "sass": sass_report(root, build, build.library_path(), sms)}
    for label, i, gamma in FOCAL_CASES:
        x, y = focal_inputs(FOCAL_SHAPES[i], SEED + i)

        def call(x=x, y=y, gamma=gamma):
            return focal_fwd(x, y, gamma, 0.25)

        got, want = call(), focal_plain(x, y, gamma, 0.25)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        if not err <= ELEM_TOL:
            raise AssertionError(f"{label}: max abs err {err} of max "
                                 f"|plain|, above {ELEM_TOL}")
        row[f"{label}_max_rel_err"] = err
        timed(row, label, call, 16 * x.numel())
        if gamma == 2.0:
            # ATen moving focal's bytes under the same flush: x copied into
            # one output and y into the other
            a, b = torch.empty_like(x), torch.empty_like(x)

            def copies(a=a, b=b, x=x, y=y):
                a.copy_(x)
                b.copy_(y)

            timed(row, f"aten_copy_{label[6:]}", copies, 16 * x.numel())
            del a, b
        del x, y, got, want
    x, y = dice_inputs()
    for label, pexp in DICE_CASES:
        def call(pexp=pexp):
            return soft_dice_sums(x, y, pexp)

        got, again = call(), call()
        want = soft_dice_sums_plain(x, y, pexp)
        torch.cuda.synchronize()
        err = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
                  for g, w in zip(got, want))
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        if not err <= DICE_TOL or not same:
            raise AssertionError(f"{label}: max rel err {err} (tolerance "
                                 f"{DICE_TOL}), same bits twice {same}")
        row[f"{label}_max_rel_err"] = err
        timed(row, label, call, 8 * x.numel() + 8 * x.shape[0])
    # ATen reading soft-Dice's bytes under the same flush: one sum over x
    # and y laid end to end
    xy = torch.cat([x.view(-1), y.view(-1)])
    timed(row, "aten_sum_dice", lambda: xy.sum(), 4 * xy.numel())
    return row


TIMED = (tuple(c[0] for c in FOCAL_CASES) + tuple(c[0] for c in DICE_CASES)
         + ("aten_copy_g2_6x512", "aten_copy_g2_20x224", "aten_sum_dice"))


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
        return {f"{k}_{t}_ms": (a[f"{k}_{t}_ms"] + b[f"{k}_{t}_ms"]) / 2
                for k in TIMED for t in ("device", "warm", "events")}

    print(json.dumps({
        "order": "parent change change parent", "card": rows[0]["card"],
        "parent": side(rows[0], rows[3]), "change": side(rows[1], rows[2]),
        "bound_ms": {k: rows[1][f"{k}_bound_ms"] for k in TIMED},
        "graph": {"parent": {k: rows[0][f"{k}_graph"] for k in TIMED},
                  "change": {k: rows[1][f"{k}_graph"] for k in TIMED}},
        "sass_per_element": {"parent": rows[0]["sass"]["per_element"],
                             "change": rows[1]["sass"]["per_element"]},
        "issue_ms": {"parent": rows[0]["sass"]["issue_ms"],
                     "change": rows[1]["sass"]["issue_ms"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
