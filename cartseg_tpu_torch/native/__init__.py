"""Native host runtime (counterpart of cartseg_tpu/native/): the exact
EDT and the fused letterbox + bilinear resize of the data loader, and
the outer contours and thick polylines of the overlays, C++ called
through ctypes.

`edt.cpp` and `preproc.cpp` are this package's own copies of the JAX
package's sources, with the same C ABI; `contours.cpp` is the port's
own (cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) and
cv2.drawContours, which the JAX package calls). They are compiled at first use
with g++ and the JAX package's flags (-O3 -march=native -fopenmp), so
the two libraries built on one machine give the same bytes, into
`native/_build/` (listed in .gitignore) under a name that carries a
hash of the sources, the flags and the host CPU's model and features. Unlike the JAX module, nothing falls
back to scipy or cv2: a failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "edt.cpp", _HERE / "preproc.cpp", _HERE / "contours.cpp")
BUILD_DIR = _HERE / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")


def _cpu() -> bytes:
    """The host CPU's model and feature flags: -march=native code built
    on one CPU may not run on another, so they are part of the name."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_cpu())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcartseg_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for these sources exists; raise
    with g++'s stderr if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td) / out.name
        cmd = ["g++", *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(
                "g++ not found; the native host library "
                "(cartseg_tpu_torch/native) is compiled at first use") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.edt_sq.argtypes = [u8p, f32p, ctypes.c_int, ctypes.c_int]
    lib.edt_sq.restype = None
    lib.letterbox_resize_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8]
    lib.letterbox_resize_u8.restype = None
    lib.resize_nearest_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.resize_nearest_u8.restype = None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.cartseg_find_external_contours.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, i32p, i64, i32p, i64,
        ctypes.POINTER(i64)]
    lib.cartseg_find_external_contours.restype = i64
    lib.cartseg_draw_contours.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, i64, u8p,
        ctypes.c_int]
    lib.cartseg_draw_contours.restype = None
    return lib


def edt_exact(seeds: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance to the nearest nonzero pixel (float32)."""
    lib = get_lib()
    seeds = np.ascontiguousarray(seeds.astype(np.uint8))
    h, w = seeds.shape
    out = np.empty((h, w), np.float32)
    lib.edt_sq(seeds, out, h, w)
    return np.sqrt(out)


def distance_transform_edt(mask: np.ndarray) -> np.ndarray:
    """scipy semantics: for nonzero pixels, distance to nearest zero."""
    mask = mask > 0
    d = edt_exact(~mask)
    d[~mask] = 0.0
    return d


def letterbox_resize(img: np.ndarray, out_hw, side_ratio: float = 0.1,
                     pad=(0, 0, 0)) -> np.ndarray:
    """Fused letterbox (side pad, then square pad) + bilinear resize of
    an HxWx3 uint8 image to out_hw, in one pass."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw = img.shape[:2]
    dh, dw = out_hw
    out = np.empty((dh, dw, 3), np.uint8)
    lib.letterbox_resize_u8(img, sh, sw, out, dh, dw,
                            ctypes.c_float(side_ratio),
                            pad[0], pad[1], pad[2])
    return out


def resize_nearest(mask: np.ndarray, out_hw) -> np.ndarray:
    """Nearest resize of an HxW uint8 mask, floor(i * src / dst) in
    double precision (within ~1 % of cv2's INTER_NEAREST)."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    sh, sw = mask.shape
    dh, dw = out_hw
    out = np.empty((dh, dw), np.uint8)
    lib.resize_nearest_u8(mask, sh, sw, out, dh, dw)
    return out


def find_external_contours(mask: np.ndarray) -> list:
    """cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0] of an
    HxW mask (nonzero is foreground): a list of int32 [N, 2] (x, y)
    arrays, the last found by the raster scan first, as cv2 lists them."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    pts_cap, lens_cap = 4 * (h + w) + 64, 64
    while True:
        pts = np.empty((pts_cap, 2), np.int32)
        lens = np.empty(lens_cap, np.int32)
        n_pts = ctypes.c_int64(0)
        n = lib.cartseg_find_external_contours(mask, h, w, pts, pts_cap,
                                               lens, lens_cap,
                                               ctypes.byref(n_pts))
        if n <= lens_cap and n_pts.value <= pts_cap:
            break
        pts_cap, lens_cap = max(pts_cap, n_pts.value), max(lens_cap, n)
    if n == 0:
        return []
    return np.split(pts[:n_pts.value], np.cumsum(lens[:n])[:-1])[::-1]


def draw_contours(image: np.ndarray, contours, colour,
                  thickness: int) -> None:
    """cv2.drawContours(image, contours, -1, colour, thickness) in place,
    for an HxWxC uint8 image and thickness > 1 (LINE_8)."""
    if thickness < 2:
        raise ValueError(f"thickness must be > 1, got {thickness}")
    if image.dtype != np.uint8 or image.ndim != 3 or \
            not image.flags.c_contiguous:
        raise ValueError("draw_contours takes a C-contiguous HxWxC uint8 "
                         f"image, got {image.dtype} {image.shape}")
    h, w, cn = image.shape
    colour = np.asarray(colour, np.uint8).reshape(-1)
    if colour.size != cn:
        raise ValueError(f"colour has {colour.size} values for {cn} channels")
    if not len(contours):
        return
    lens = np.array([len(c) for c in contours], np.int32)
    pts = np.ascontiguousarray(np.concatenate(contours).reshape(-1, 2),
                               np.int32)
    get_lib().cartseg_draw_contours(image, h, w, cn, pts, lens, len(lens),
                                    colour, int(thickness))
