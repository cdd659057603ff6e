"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc into one shared library with a
plain C interface, at first use, into `ops/cuda/_build/` (listed in
.gitignore), and loaded with ctypes. The sources compile in parallel,
one nvcc process each, and are then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libcartseg_kernels_<hash>.so *.o

The file name carries a hash of the sources, the `csrc/*.cuh` headers
they include and the flags, so an edited source rebuilds and a stale
library is never loaded. Nothing is built or imported at module import
time: the CPU tests import every module, and this machine class has no
nvcc.

Each wrapper counts its launches in `LAUNCHES` (one per call that
launched its kernel), so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

LAUNCHES = {"cc": 0, "reach": 0, "median": 0, "edt": 0, "lsr_fwd": 0,
            "lsr_bwd": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "channel_sums": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (fg, labels, B, H, W, connectivity, stream)
    "cartseg_cc_label": (_P, _P, _I, _I, _I, _I, _P),
    # (weak, strong, lab scratch, flag scratch, out, B, H, W, stream)
    "cartseg_reach": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # (x, hist scratch, state scratch, out, B, N, stream)
    "cartseg_median_nonneg": (_P, _P, _P, _P, _I, _I, _P),
    # (seeds, state a, state b, dist, B, H, W, stream)
    "cartseg_edt": (_P, _P, _P, _P, _I, _I, _I, _P),
    # (x, labels, loss, n, C, lb_pos, lb_neg, ignore, stream)
    "cartseg_lsr_fwd": (_P, _P, _P, _L, _I, _F, _F, _I, _P),
    # (x, labels, g, grad, n, C, lb_pos, lb_neg, ignore, stream)
    "cartseg_lsr_bwd": (_P, _P, _P, _P, _L, _I, _F, _F, _I, _P),
    # (q, k, v, rel_h, rel_w, out, lse or null, bnh, S, g, hd, bf16, scale,
    #  stream)
    "cartseg_flash_relpos_fwd": (_P,) * 7 + (_I,) * 5 + (_F, _P),
    # (q, k, v, rel_h, rel_w, dO, lse, D, dq, drel_h, drel_w, bnh, S, g, hd,
    #  bf16, scale, stream)
    "cartseg_flash_relpos_bwd_dq": (_P,) * 11 + (_I,) * 5 + (_F, _P),
    # (q, k, v, rel_h, rel_w, dO, lse, D, dk, dv, bnh, S, g, hd, bf16,
    #  scale, stream)
    "cartseg_flash_relpos_bwd_dkv": (_P,) * 10 + (_I,) * 5 + (_F, _P),
    # (a, b, partials, out, a_bf16, b_bf16, same, nhwc, N, C, HW, vec, P,
    #  tc, R, stream)
    "cartseg_channel_sums": (_P,) * 4 + (_I,) * 4 + (_L, _I, _L) + (_I,) * 4
    + (_P,),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are compiled at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcartseg_kernels_{h.hexdigest()[:16]}.so"


# the compiler's -Xptxas -v report of the last build in this process
BUILD_LOG = {"text": ""}


def _run_all(cmds) -> str:
    """Run the commands at once; raise on the first that failed, else
    return their output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [str(Path(td) / f"{src.stem}.o") for src in _sources()]
        log = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                       for obj, src in zip(objs, _sources()))
        tmp = str(Path(td) / out.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)
    BUILD_LOG["text"] = log
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.cartseg_error_string.argtypes = [ctypes.c_int]
    lib.cartseg_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = load_library().cartseg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
