"""Write the JPEG fixtures of the card's JPEG reader (utils/jpeg.py).

    python -m cartseg_tpu_torch.tools.make_jpeg_fixtures [--out DIR]

Needs OpenCV (cv2): it encodes the JPEGs and stores cv2's decode of
each, which the card's nvJPEG decode is held against (chip_smoke.py
phase 4h, tests/test_torch_jpeg_cuda.py). Everything is drawn from one
seed, so a rerun writes the same pixels. Into `--out` (default
cartseg_tpu_torch/tools/jpeg_fixtures/) it writes:

  frame_<k>.jpeg        8 cart-like camera frames at 1280x720, baseline,
                        4:2:0 chroma, quality 90;
  frame_<k>.mask.png    each frame's cart mask in letterboxed space
                        (side padding 0.1, square: 1536x1536), as the
                        reference's masks are stored;
  frame_0_444.jpeg      frame 0 with 4:4:4 chroma;
  frame_1_progressive.jpeg  frame 1, progressive;
  frame_2_exif6.jpeg    frame 2 with EXIF Orientation 6 (shown rotated
                        90 degrees clockwise, 720x1280);
  frame_3_gray.jpeg     frame 3 as a one-component (grayscale) JPEG;
  <jpeg stem>.cv2.png   cv2.imread(IMREAD_COLOR) of every JPEG, as RGB;
  frame_0.cv2gray.png   cv2.imread(IMREAD_GRAYSCALE) of frame_0.jpeg.
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.utils.image_io import encode_png

SEED = 16
HW = (720, 1280)
N_FRAMES = 8
QUALITY = 90
OUT = Path(__file__).resolve().parent / "jpeg_fixtures"


def _poly_mask(h: int, w: int, pts) -> np.ndarray:
    """Inside of a convex polygon (points in order) on an h x w grid."""
    yy, xx = np.mgrid[:h, :w]
    inside = np.ones((h, w), bool)
    n = len(pts)
    for i in range(n):
        (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % n]
        side = (x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)
        # the sign of the side the next vertex lies on is the inside's
        s = np.sign((x1 - x0) * (pts[(i + 2) % n][1] - y0)
                    - (y1 - y0) * (pts[(i + 2) % n][0] - x0))
        inside &= side * s >= 0
    return inside


def cart_frame(rng: np.random.Generator):
    """An RGB uint8 frame of a shopping cart in a store aisle and the
    cart's mask: wall with shelf products, tiled floor, a wire basket
    seen through its grid, a red handle, wheels; a light blur and sensor
    noise."""
    import cv2

    h, w = HW
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    horizon = int(rng.integers(int(h * 0.38), int(h * 0.5)))
    wall = rng.uniform(150, 210, 3).astype(np.float32)
    floor = rng.uniform(90, 150, 3).astype(np.float32)
    img = np.where((yy < horizon)[..., None],
                   wall * (0.85 + 0.15 * yy[..., None] / horizon),
                   floor * (0.8 + 0.2 * (yy[..., None] - horizon)
                            / (h - horizon)))
    # shelf products: coloured boxes along the wall
    for _ in range(int(rng.integers(10, 18))):
        bw, bh = rng.integers(40, 140), rng.integers(40, 120)
        x0 = int(rng.integers(0, w - bw))
        y0 = int(rng.integers(20, max(21, horizon - bh)))
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(30, 240, 3)
    # floor tiles: dark joints in perspective
    for k in range(-12, 13):
        x_far = w / 2 + k * 60
        x_near = w / 2 + k * 260
        t = (yy - horizon) / (h - horizon)
        xl = x_far + (x_near - x_far) * t
        img[(yy > horizon) & (np.abs(xx - xl) < 1.5)] *= 0.8
    for r in range(1, 8):
        y = horizon + (h - horizon) * (r / 8) ** 1.6
        img[np.abs(yy - y) < 1.5] *= 0.8

    # the cart: a basket trapezoid, its wire grid, handle and wheels
    cx = int(rng.integers(int(w * 0.3), int(w * 0.7)))
    top = int(rng.integers(int(h * 0.25), int(h * 0.4)))
    bot = int(rng.integers(int(h * 0.65), int(h * 0.78)))
    half_top = int(rng.integers(200, 300))
    half_bot = int(half_top * rng.uniform(0.6, 0.8))
    basket = _poly_mask(h, w, [(cx - half_top, top), (cx + half_top, top),
                               (cx + half_bot, bot), (cx - half_bot, bot)])
    grid = ((np.mod(xx - cx, 16) < 2.5) | (np.mod(yy - top, 16) < 2.5))
    metal = np.array([178, 180, 186], np.float32)
    img[basket & grid] = metal
    img[basket & ~grid] = img[basket & ~grid] * 0.7 + metal * 0.15
    handle = (np.abs(yy - (top - 14)) < 7) & \
        (np.abs(xx - cx) < half_top + 20)
    img[handle] = (200, 30, 35)
    cart = basket | handle
    legs = np.zeros_like(cart)
    for sx in (-1, 1):
        leg = (np.abs(xx - (cx + sx * half_bot * 0.9)) < 5) & \
            (yy >= bot) & (yy < bot + 60)
        wheel = (xx - (cx + sx * half_bot * 0.9)) ** 2 + \
            (yy - (bot + 70)) ** 2 < 18 ** 2
        img[leg] = metal
        img[wheel] = (25, 25, 28)
        legs |= leg | wheel
    cart |= legs

    img = cv2.GaussianBlur(img, (0, 0), 0.8)
    img = img + rng.normal(0, 1.2, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8), cart


def with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """JPEG bytes with an APP1 Exif segment (big-endian TIFF, IFD0 with
    one Orientation entry) inserted after the APP0 JFIF segment."""
    tiff = (b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))
    body = b"Exif\0\0" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    pos = 2
    if jpeg[2:4] == b"\xff\xe0":
        (n,) = struct.unpack(">H", jpeg[4:6])
        pos = 4 + n
    return jpeg[:pos] + app1 + jpeg[pos:]


def _encode(rgb_or_gray: np.ndarray, *params) -> bytes:
    import cv2

    img = rgb_or_gray if rgb_or_gray.ndim == 2 else \
        cv2.cvtColor(rgb_or_gray, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpeg", img,
                           [cv2.IMWRITE_JPEG_QUALITY, QUALITY, *params])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def _write_png(path: Path, img: np.ndarray) -> None:
    """PNG rows with the Up filter: as small as cv2's adaptive filters on
    these frames, and the port's PNG codec decodes them without a loop
    along each row."""
    path.write_bytes(encode_png(img, row_filter=2))


def write_fixtures(out: Path = OUT) -> list:
    """Write every fixture into `out`; returns the JPEG paths."""
    import cv2

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    jpegs = {}
    frames = []
    for k in range(N_FRAMES):
        rgb, cart = cart_frame(rng)
        frames.append(rgb)
        jpegs[f"frame_{k}"] = _encode(rgb)
        mask = G.letterbox_side_pad(cart.astype(np.uint8) * 255)
        _write_png(out / f"frame_{k}.mask.png", mask)
    jpegs["frame_0_444"] = _encode(frames[0],
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    jpegs["frame_1_progressive"] = _encode(frames[1],
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    jpegs["frame_2_exif6"] = with_exif_orientation(_encode(frames[2]), 6)
    jpegs["frame_3_gray"] = _encode(
        cv2.cvtColor(frames[3], cv2.COLOR_RGB2GRAY))
    paths = []
    for stem, data in jpegs.items():
        p = out / f"{stem}.jpeg"
        p.write_bytes(data)
        paths.append(p)
        bgr = cv2.imread(str(p), cv2.IMREAD_COLOR)
        _write_png(out / f"{stem}.cv2.png",
                   cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    gray = cv2.imread(str(out / "frame_0.jpeg"), cv2.IMREAD_GRAYSCALE)
    _write_png(out / "frame_0.cv2gray.png", gray)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    for p in write_fixtures(Path(args.out)):
        print(p)


if __name__ == "__main__":
    main()
