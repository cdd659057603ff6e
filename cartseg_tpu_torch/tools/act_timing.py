"""Check and time forms of the port's mish forward kernel against
`F.mish` on the card, and set their instruction mix beside ATen's:

    python cartseg_tpu_torch/tools/act_timing.py [--source FILE ...]
        [--pairs N] [--out DIR]

builds each `--source` (a form of csrc/activations.cu with its C entry
point `cartseg_activation`; by default the checkout's own) alone with nvcc
into a library of its own, holds its mish forward against `act_fwd_plain`
within chip_smoke.ELEM_TOL of max |plain| at chip_smoke's path input
([6,512,512,16], 3 N(0,1)) and at the edge values of the card tests
(mish's guard at 20 and its neighbours, +-100), then times it against
F.mish at the path input in `--pairs` alternating pairs, the L2 flushed
before every call (chip_smoke.device_ms(..., cold=True); the kernel first
in the even pairs, F.mish in the odd), and prints the medians and each
series' spread, (max - min) / median. Beside that: the SASS instructions
of each form's vectorised mish forward and of ATen's mish forward kernels
in libtorch_cuda.so by opcode (cuobjdump -sass; ATen's sm_90 code, whose
SASS goes to `--out`, by default the git-ignored
ops/cuda/_build/act_timing), their registers, and the launch configuration
of each kernel as the profiler's trace records it (grid, block,
registers). One JSON line at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from flash_bwd_timing import opcode_counts

ROOT = Path(__file__).resolve().parents[2]
# the edge values of tests/test_torch_kernels_cuda.py's activation inputs
EDGES = (-3.0, 3.0, -2.9999998, -3.0000002, 2.9999998, 3.0000002, 20.0,
         19.999998, 20.000002, 0.0, -20.0, 25.0, -100.0, 100.0)


def registers(cuobjdump: Path, target: Path, key) -> dict:
    """{function: registers} from cuobjdump -res-usage, over the functions
    for which key(name) is not None."""
    text = subprocess.run([str(cuobjdump), "-res-usage", str(target)],
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function" in line:
            fn = line.split("Function", 1)[1].strip(" :")
        elif fn and "REG:" in line and key(fn) is not None:
            out[fn] = int(line.split("REG:")[1].split()[0])
    return out


def aten_mish_fwd(name: str):
    """name, if it is one of ATen's mish forward kernels, else None."""
    return name if "mish_kernel" in name and "backward" not in name else None


def port_mish_fwd(name: str):
    """name, if it is a form's vectorised mish forward, else None."""
    return name if "act_fwd" in name and "Mish" in name and "Lb1E" in name \
        else None


def aten_sass(cuobjdump: Path, out_dir: Path) -> dict:
    """ATen's mish forward kernels for sm_90: the cubins of libtorch_cuda.so
    extracted (cuobjdump -xelf sm_90), the ones holding a mish_kernel
    symbol disassembled; their opcode counts and registers, the SASS text
    written to out_dir."""
    import torch

    lib = Path(torch.__file__).resolve().parent / "lib" / "libtorch_cuda.so"
    with tempfile.TemporaryDirectory() as td:
        subprocess.run([str(cuobjdump), "-xelf", "sm_90", str(lib)], cwd=td,
                       capture_output=True, check=True, timeout=600)
        mix, regs = {}, {}
        for cubin in sorted(Path(td).iterdir()):
            if b"mish_kernel" not in cubin.read_bytes():
                continue
            sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            mix.update(opcode_counts(sass, aten_mish_fwd))
            regs.update(registers(cuobjdump, cubin, aten_mish_fwd))
            (out_dir / f"aten_{cubin.name}.sass").write_text(sass)
    return {"sass": mix, "registers": regs}


def launch_configs(fns: dict) -> dict:
    """{label: [(kernel, grid, block, registers)]} from the profiler's
    chrome trace of one call of each fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        out[label] = [(e["name"][:120], e["args"].get("grid"),
                       e["args"].get("block"),
                       e["args"].get("registers per thread"))
                      for e in events if e.get("cat") == "kernel"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, action="append")
    ap.add_argument("--pairs", type=int, default=7)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "cartseg_tpu_torch" / "ops" / "cuda" /
                    "_build" / "act_timing")
    args = ap.parse_args(argv)
    sources = args.source or [
        ROOT / "cartseg_tpu_torch" / "ops" / "cuda" / "csrc" /
        "activations.cu"]
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.activations import act_fwd_plain

    if not torch.cuda.is_available():
        print("act_timing: no CUDA device", file=sys.stderr)
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    x, _ = cs.act_inputs(cs.ACT_SHAPES[0], "cuda", cs.SEED)
    edges = torch.tensor(EDGES, device="cuda")
    n = x.numel()
    res = {"card": cs.card_line(), "shape": list(cs.ACT_SHAPES[0]),
           "forms": {}}
    with tempfile.TemporaryDirectory() as td:
        libs = [Path(td) / f"act{i}.so" for i in range(len(sources))]
        build._run_all([nvcc, *flags, "-shared", "-o", str(so), str(src)]
                       for so, src in zip(libs, sources))
        kernels = {}
        for src, so in zip(sources, libs):
            lib = ctypes.CDLL(str(so))
            fn = lib.cartseg_activation
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def mish(t, fn=fn):
                o = torch.empty_like(t)
                rc = fn(0, t.data_ptr(), None, o.data_ptr(), t.numel(),
                        build.aligned16(t, o),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{src}: CUDA error {rc}")
                return o

            errs = []
            for t in (x, edges):
                got, want = mish(t), act_fwd_plain(t, "mish")
                torch.cuda.synchronize()
                errs.append(float((got - want).abs().max()
                                  / want.abs().max()))
            if max(errs) > cs.ELEM_TOL:
                raise AssertionError(f"{src}: max abs err over max |plain| "
                                     f"{errs} above {cs.ELEM_TOL}")
            series = {"kernel": [], "F.mish": []}
            for i in range(args.pairs):
                for who in (("kernel", "F.mish") if i % 2 == 0
                            else ("F.mish", "kernel")):
                    series[who].append(
                        cs.device_ms(lambda: mish(x), 10, "act_fwd",
                                     cold=True) if who == "kernel" else
                        cs.device_ms(lambda: F.mish(x), 10, cold=True))
            med = {w: float(np.median(v)) for w, v in series.items()}
            spread = {w: (max(v) - min(v)) / med[w]
                      for w, v in series.items()}
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            res["forms"][str(src)] = {
                "max_rel_err": errs, "median_ms": med, "spread": spread,
                "gap": (med["kernel"] - med["F.mish"]) / med["F.mish"],
                "bound_ms": cs.bytes_bound(8 * n)[0],
                "sass": opcode_counts(sass, port_mish_fwd),
                "registers": registers(cuobjdump, so, port_mish_fwd)}
            kernels[str(src)] = lambda mish=mish: mish(x)
            print(json.dumps({str(src): res["forms"][str(src)]}),
                  flush=True)
        res["launch"] = launch_configs({**kernels,
                                        "F.mish": lambda: F.mish(x)})
    try:
        res["aten"] = aten_sass(cuobjdump, args.out)
    except (OSError, subprocess.SubprocessError) as e:
        res["aten"] = f"not read: {e!r}"[:300]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
