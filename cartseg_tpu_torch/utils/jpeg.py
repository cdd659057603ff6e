"""JPEG reading on the card through nvJPEG, the CUDA toolkit's decoder.

The card's installation has no OpenCV or PIL, and the reference trees
hold .jpeg frames. `read_rgb` / `read_gray` decode a file with nvJPEG
into a uint8 tensor on the card, on the calling thread's own stream,
copy it to the host and apply the file's EXIF orientation as
`cv2.imread` does. RGB comes out interleaved (NVJPEG_OUTPUT_RGBI), a
gray read is the luma plane (NVJPEG_OUTPUT_Y), which is what
IMREAD_GRAYSCALE gives for a colour JPEG.

nvJPEG is bound through `native/nvjpeg_shim.cpp`, a small C library
compiled with g++ at the first read and linked with -lnvjpeg from
$CUDA_HOME (default /usr/local/cuda) into `native/_build/`. It is kept
out of the kernel library: a toolkit without libnvjpeg fails JPEG reads
only. One nvJPEG handle serves the process; every thread that decodes
owns its decode state and its stream (a state must not be shared
between threads). A missing toolkit, a failed build and a file nvJPEG
cannot decode (CMYK, arithmetic coding, ...) each raise with the reason.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from cartseg_tpu_torch import native

SHIM = Path(native.__file__).resolve().parent / "nvjpeg_shim.cpp"
# EXIF IFD0 tag of the orientation (a SHORT, 1-8)
_ORIENTATION_TAG = 0x0112


def cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
                or "/usr/local/cuda")


def _flags() -> tuple:
    home = cuda_home()
    return ("-O2", "-std=c++17", "-shared", "-fPIC", f"-I{home}/include",
            f"-L{home}/lib64", "-lnvjpeg", f"-Wl,-rpath,{home}/lib64")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_flags()).encode())
    h.update(SHIM.read_bytes())
    return native.BUILD_DIR / f"libcartseg_nvjpeg_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the shim unless it exists; raise with g++'s stderr."""
    out = library_path()
    if out.exists():
        return out
    header = cuda_home() / "include" / "nvjpeg.h"
    if not header.exists():
        raise RuntimeError(f"nvJPEG not found: no {header} (set CUDA_HOME "
                           "to the CUDA toolkit); JPEG reads on the card "
                           "need it")
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as td:
        tmp = Path(td) / out.name
        flags = _flags()
        # the sources before the libraries, so -lnvjpeg resolves them
        cmd = ["g++", *flags[:5], "-o", str(tmp), str(SHIM), *flags[5:]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the nvJPEG shim failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    sigs = {"cs_nvjpeg_create": (ctypes.POINTER(P),),
            "cs_nvjpeg_state_create": (P, ctypes.POINTER(P)),
            "cs_nvjpeg_state_destroy": (P,),
            "cs_nvjpeg_info": (P, ctypes.c_char_p, Z) + (
                ctypes.POINTER(I),) * 4,
            "cs_nvjpeg_known_subsampling": (I,),
            "cs_nvjpeg_decode": (P, P, ctypes.c_char_p, Z, I, P, Z, P)}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = I
    lib.cs_nvjpeg_status_name.argtypes = [I]
    lib.cs_nvjpeg_status_name.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        name = _lib().cs_nvjpeg_status_name(rc).decode()
        raise RuntimeError(f"{what}: nvJPEG status {rc} ({name})")


@functools.lru_cache(maxsize=1)
def _handle() -> int:
    h = ctypes.c_void_p()
    _check(_lib().cs_nvjpeg_create(ctypes.byref(h)), "nvjpegCreateSimple")
    return h.value


class _Decoder:
    """A thread's nvJPEG decode state and CUDA stream; the state is
    destroyed with the thread's locals."""

    def __init__(self, device):
        import torch

        st = ctypes.c_void_p()
        _check(_lib().cs_nvjpeg_state_create(_handle(), ctypes.byref(st)),
               "nvjpegJpegStateCreate")
        self.state = st.value
        # held here: module globals may be gone when a thread's locals
        # are collected at interpreter exit
        self._destroy = _lib().cs_nvjpeg_state_destroy
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def __del__(self):
        if getattr(self, "state", None):
            self._destroy(self.state)
            self.state = None


_local = threading.local()


def _cuda_device(device):
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG decodes on a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _decoder(device) -> _Decoder:
    device = _cuda_device(device)
    dec = getattr(_local, "decoder", None)
    if dec is None or dec.device != device:
        dec = _local.decoder = _Decoder(device)
    return dec


def decode(data: bytes, gray: bool = False, device="cuda", name="<bytes>"):
    """JPEG bytes -> uint8 tensor on `device` ([H,W,3] RGB, or [H,W] luma
    when gray), decoded on the current stream. The orientation is not
    applied (see `read_rgb`)."""
    import torch

    device = _cuda_device(device)
    lib = _lib()
    comps, css, w, h = (ctypes.c_int() for _ in range(4))
    _check(lib.cs_nvjpeg_info(_handle(), data, len(data), ctypes.byref(comps),
                              ctypes.byref(css), ctypes.byref(w),
                              ctypes.byref(h)),
           f"{name}: nvjpegGetImageInfo")
    if comps.value not in (1, 3) or \
            not lib.cs_nvjpeg_known_subsampling(css.value):
        raise RuntimeError(
            f"{name}: nvJPEG cannot decode a JPEG of {comps.value} "
            f"components and chroma subsampling {css.value} (CMYK and "
            "other layouts are not read on the card)")
    shape = (h.value, w.value) if gray else (h.value, w.value, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device)
    _check(lib.cs_nvjpeg_decode(_handle(), _decoder(device).state, data,
                                len(data), int(gray), out.data_ptr(),
                                out.stride(0), stream.cuda_stream),
           f"{name}: nvjpegDecode")
    return out


def exif_orientation(data: bytes) -> int:
    """The EXIF Orientation (1-8) of JPEG bytes; 1 where there is none.
    Reads the first APP1 "Exif" segment's IFD0, before the scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):               # end of image, scan
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker != 0xE1 or not seg.startswith(b"Exif\0\0"):
            continue
        tiff = seg[6:]
        end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if end is None or len(tiff) < 8:
            return 1
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        if ifd + 2 > len(tiff):
            return 1
        (count,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            e = ifd + 2 + 12 * i
            if e + 12 > len(tiff):
                break
            tag, typ = struct.unpack(end + "HH", tiff[e:e + 4])
            if tag == _ORIENTATION_TAG and typ == 3:
                (v,) = struct.unpack(end + "H", tiff[e + 8:e + 10])
                return v if 1 <= v <= 8 else 1
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an image as `cv2.imread` turns a JPEG of this EXIF
    orientation (OpenCV's ExifTransform: transpose, then flip)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 6):                    # flip around the y axis
        img = img[:, ::-1]
    elif orientation in (3, 7):                  # both axes
        img = img[::-1, ::-1]
    elif orientation in (4, 8):                  # around the x axis
        img = img[::-1]
    return np.ascontiguousarray(img)


def _read(path, gray: bool, device) -> np.ndarray:
    import torch

    path = Path(path)
    data = path.read_bytes()
    dec = _decoder(device)
    with torch.cuda.stream(dec.stream):
        out = decode(data, gray, dec.device, name=path.name)
        dec.stream.synchronize()
        host = out.cpu().numpy()
    return apply_orientation(host, exif_orientation(data))


def read_rgb(path, device="cuda") -> np.ndarray:
    """HxWx3 uint8 RGB of a JPEG file, decoded by nvJPEG on `device`."""
    return _read(path, False, device)


def read_gray(path, device="cuda") -> np.ndarray:
    """HxW uint8 luma of a JPEG file, decoded by nvJPEG on `device`."""
    return _read(path, True, device)
