"""Image reading and writing for the host loop.

With OpenCV installed, images are read and written through cv2, as the
JAX workload does (cartseg_tpu/infer/pseudo_labels.py:166-169, :215).
Without it (the GPU machines this port targets carry neither OpenCV nor
PIL), a small PNG codec built on stdlib `zlib` takes over: it writes
8-bit gray and RGB PNGs and reads back non-interlaced 8-bit PNGs
(gray, gray+alpha, RGB, RGBA) with all five row filter types. A JPEG
read for a CUDA device is decoded on the card by nvJPEG (utils/jpeg.py);
on the CPU, JPEG and the other formats need cv2 and raise without it.
"""

from __future__ import annotations

import importlib.util
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def have_cv2() -> bool:
    return importlib.util.find_spec("cv2") is not None


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image: np.ndarray, row_filter: int = 0) -> bytes:
    """HxW or HxWx3 uint8 (RGB) -> PNG bytes, every row with filter type
    `row_filter`: 0 (None) or 2 (Up, which compresses smooth images
    better and decodes without a loop along the row)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {image.dtype}")
    if image.ndim == 2:
        ctype = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"encode_png takes HxW or HxWx3, got {image.shape}")
    if row_filter not in (0, 2):
        raise ValueError(f"row_filter must be 0 or 2, got {row_filter}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    if row_filter == 2:
        rows = rows - np.concatenate([np.zeros_like(rows[:1]), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), row_filter, np.uint8), rows],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 9 if row_filter
                                            else 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(buf[y, 0]), buf[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:     # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:     # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(stride)
            pr = prior.tolist()
            ln = line.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = pr[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + pr[i]) >> 1
                else:
                    pred = _paeth(a, pr[i], c)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HxW or HxWxC uint8 array (8-bit, non-interlaced)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); only non-interlaced 8-bit "
            "gray/RGB(A) is read without OpenCV")
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, ch)


def _device_type(device) -> str:
    return device.type if hasattr(device, "type") else \
        str(device).split(":")[0]


def _card_jpeg(path: Path, device) -> bool:
    """True where a read goes to nvJPEG: a JPEG file read for a card."""
    return _device_type(device) == "cuda" and \
        path.suffix.lower() in (".jpg", ".jpeg")


def read_rgb(path, device="cpu") -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB, or None where cv2.imread would give None (a
    missing file). For a CUDA `device` a JPEG is decoded on the card by
    nvJPEG (utils/jpeg.py, EXIF orientation applied as cv2 does); else
    the file goes through cv2, and without cv2 only PNGs are read (the
    zlib codec)."""
    path = Path(path)
    if _card_jpeg(path, device):
        if not path.exists():
            return None
        from cartseg_tpu_torch.utils import jpeg

        return jpeg.read_rgb(path, device)
    if have_cv2():
        import cv2

        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
        return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if path.suffix.lower() != ".png":
        raise RuntimeError(
            f"reading {path.name} needs OpenCV (cv2), which is not "
            "installed; without it only PNG inputs are read (and JPEG "
            "on a card, through nvJPEG)")
    img = decode_png(path.read_bytes())
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 2:                  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_gray(path, device="cpu") -> Optional[np.ndarray]:
    """HxW uint8 (a mask), or None where cv2.imread would give None. For
    a CUDA `device` a JPEG is decoded on the card to its luma plane, as
    IMREAD_GRAYSCALE reads it. Without cv2, PNGs must be gray (or gray +
    alpha): cv2's colour to gray conversion is not reproduced."""
    path = Path(path)
    if _card_jpeg(path, device):
        if not path.exists():
            return None
        from cartseg_tpu_torch.utils import jpeg

        return jpeg.read_gray(path, device)
    if have_cv2():
        import cv2

        return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if path.suffix.lower() != ".png":
        raise RuntimeError(
            f"reading {path.name} needs OpenCV (cv2), which is not "
            "installed; without it only PNG masks are read (and JPEG on "
            "a card, through nvJPEG)")
    img = decode_png(path.read_bytes())
    if img.ndim == 3 and img.shape[2] == 2:
        return np.ascontiguousarray(img[..., 0])
    if img.ndim != 2:
        raise RuntimeError(
            f"{path.name} is a colour PNG; reading it as a gray mask "
            "needs OpenCV (cv2), which is not installed")
    return img


def write_png(path, image: np.ndarray) -> None:
    """Write HxW gray or HxWx3 RGB uint8 as PNG (cv2.imwrite when
    installed, as the JAX workload writes, else the zlib codec)."""
    if have_cv2():
        import cv2

        img = image if image.ndim == 2 else cv2.cvtColor(
            image, cv2.COLOR_RGB2BGR)
        if not cv2.imwrite(str(path), img):
            raise OSError(f"cv2.imwrite failed for {path}")
        return
    Path(path).write_bytes(encode_png(image))


def resize_bilinear_u8(image, hw):
    """cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR) without
    OpenCV, on the tensor's device: half-pixel bilinear without
    antialiasing (INTER_LINEAR does not antialias), rounded to uint8.
    `image` is an [H,W] or [H,W,C] uint8 tensor. cv2 weighs with 11-bit
    fixed-point coefficients, so the two agree within 1 LSB. An image
    already of size `hw` is returned as it is."""
    import torch
    import torch.nn.functional as F

    h, w = int(hw[0]), int(hw[1])
    if tuple(image.shape[:2]) == (h, w):
        return image
    x = image.reshape(image.shape[0], image.shape[1], -1)
    x = x.permute(2, 0, 1)[None].to(torch.float32)
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)
    y = y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return y.reshape((h, w) + tuple(image.shape[2:])).contiguous()
