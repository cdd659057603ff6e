"""Port parity: letterbox geometry (bit-equal to cartseg_tpu.geometry)
and the stdlib PNG codec of cartseg_tpu_torch.utils.image_io (round
trips, cv2 as the oracle, all five PNG row filters). Tolerance: none,
everything here is integer."""

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cartseg_tpu import geometry as JG  # noqa: E402

from cartseg_tpu_torch import geometry as TG  # noqa: E402
from cartseg_tpu_torch.utils import image_io  # noqa: E402

SIZES = [(400, 512), (640, 480), (480, 640), (101, 37), (37, 101),
         (1920, 1080), (1, 1), (512, 400)]


@pytest.mark.parametrize("w,h", SIZES)
def test_letterbox_bit_equal_to_jax_package(w, h):
    r = np.random.default_rng(w * 7 + h)
    img = r.integers(0, 255, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(TG.letterbox_side_pad(img),
                                  JG.letterbox_side_pad(img))
    mask = img[..., 0]
    np.testing.assert_array_equal(TG.letterbox_side_pad(mask),
                                  JG.letterbox_side_pad(mask))
    a = TG.LetterboxSpec(w, h)
    b = JG.LetterboxSpec(w, h)
    assert (a.max_dim, a.content_box()) == (b.max_dim, b.content_box())


def test_400x512_frame_letterboxes_to_512_without_resize():
    img = np.random.default_rng(2).integers(0, 256, (512, 400, 3), np.uint8)
    lb = TG.letterbox_side_pad(img)
    assert lb.shape == (512, 512, 3)
    np.testing.assert_array_equal(TG.letterbox_resize(img, 512), lb)


def test_resize_matches_cv2_linear():
    """The native letterbox + resize equals letterbox_side_pad + cv2
    INTER_LINEAR where the letterbox is an integer multiple of the output
    (here 192 -> 64; other ratios: tests/test_torch_native.py)."""
    r = np.random.default_rng(3)
    img = r.integers(0, 255, (90, 160, 3), np.uint8)
    lb = TG.letterbox_side_pad(img)
    assert lb.shape == (192, 192, 3)
    np.testing.assert_array_equal(
        TG.letterbox_resize(img, 64),
        cv2.resize(lb, (64, 64), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3), (1, 1), (64, 40, 3)])
def test_png_codec_round_trip_and_cv2_reads_it(shape, tmp_path):
    r = np.random.default_rng(sum(shape))
    img = r.integers(0, 256, shape, np.uint8)
    data = image_io.encode_png(img)
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    p = tmp_path / "x.png"
    p.write_bytes(data)
    got = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        got = cv2.cvtColor(got, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, img)


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Encode rows with the given PNG filter per row (spec section 9)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, ft in enumerate(ftypes):
        cur = rows[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - a
        elif ft == 2:
            f = cur - b
        elif ft == 3:
            f = cur - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            f = cur - pred
        out.append(ft)
        out += (f % 256).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


@pytest.mark.parametrize("channels,ctype", [(1, 0), (3, 2), (4, 6), (2, 4)])
def test_png_decoder_all_filter_types(channels, ctype, tmp_path):
    r = np.random.default_rng(channels)
    h, w = 10, 13
    img = r.integers(0, 256, (h, w, channels), np.uint8)
    ftypes = [i % 5 for i in range(h)]
    raw = _filter_rows(img.reshape(h, -1), channels, ftypes)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))
    got = image_io.decode_png(data)
    np.testing.assert_array_equal(got.reshape(h, w, channels), img)
    # libpng (through cv2) agrees on the same bytes; it expands
    # gray+alpha on reading, so that type is held by the round trip only
    p = tmp_path / "f.png"
    p.write_bytes(data)
    ref = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
    if channels != 2:
        np.testing.assert_array_equal(ref.reshape(h, w, -1)[..., 0],
                                      img[..., 2 if channels >= 3 else 0])


def test_decoder_reads_what_cv2_writes(tmp_path):
    r = np.random.default_rng(11)
    img = r.integers(0, 256, (33, 47, 3), np.uint8)
    img[:, :20] = 7                     # flat areas make libpng vary filters
    p = tmp_path / "c.png"
    cv2.imwrite(str(p), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(
        image_io.decode_png(p.read_bytes()), img)


def test_decoder_rejects_what_it_cannot_read():
    with pytest.raises(ValueError):
        image_io.decode_png(b"not a png at all")
    bad = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
           + struct.pack(">IIBBBBB", 1, 1, 16, 0, 0, 0, 0) + b"\0\0\0\0")
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(bad)


def test_read_rgb_and_write_png_with_cv2(tmp_path):
    r = np.random.default_rng(5)
    img = r.integers(0, 256, (20, 30, 3), np.uint8)
    image_io.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "a.png"), img)
    assert image_io.read_rgb(tmp_path / "missing.png") is None


def test_image_io_without_cv2(tmp_path, monkeypatch):
    """The GPU machines have no OpenCV: PNGs go through the codec, and
    other formats raise instead of silently reading nothing."""
    monkeypatch.setattr(image_io, "have_cv2", lambda: False)
    r = np.random.default_rng(6)
    img = r.integers(0, 256, (12, 9, 3), np.uint8)
    image_io.write_png(tmp_path / "n.png", img)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "n.png"), img)
    gray = img[..., 1].copy()
    image_io.write_png(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "g.png"),
                                  np.repeat(gray[..., None], 3, -1))
    cv2.imwrite(str(tmp_path / "j.jpg"), img)
    with pytest.raises(RuntimeError, match="cv2"):
        image_io.read_rgb(tmp_path / "j.jpg")
