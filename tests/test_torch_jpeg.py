"""Port parity on camera JPEGs, on the CPU: the EXIF orientation that
utils/jpeg.py applies to nvJPEG's output (held against cv2.imread), the
JPEG fixtures of tools/make_jpeg_fixtures.py, the dataset's items on a
JPEG tree against cartseg_tpu.data.dataset.SegmentationDataset, and the
pseudo-labeller's frame reader against the JAX reader.

Tolerances: none, except the pseudo-label reader on the fixture with
EXIF Orientation 6 (a 720x1280 portrait frame, letterboxed to 1280^2 and
resized to 512^2, not an integer ratio): at most 1 LSB on at most 3 % of
the values against cv2 INTER_LINEAR (measured 2.7 %). nvJPEG itself runs
only on a card (tests/test_torch_jpeg_cuda.py).
"""

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cartseg_tpu import geometry as JG  # noqa: E402
from cartseg_tpu.data import pairing as JP  # noqa: E402
from cartseg_tpu.data.dataset import SegmentationDataset as JDataset  # noqa

from cartseg_tpu_torch.data import pairing as TP  # noqa: E402
from cartseg_tpu_torch.data.dataset import SegmentationDataset as TDataset  # noqa
from cartseg_tpu_torch.infer.pseudo_labels import load_frame  # noqa: E402
from cartseg_tpu_torch.tools import make_jpeg_fixtures as MF  # noqa: E402
from cartseg_tpu_torch.utils import jpeg  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401

FIXTURES = MF.OUT
JPEGS = sorted(FIXTURES.glob("*.jpeg"))


def _small_jpeg(gray=False) -> bytes:
    r = np.random.default_rng(7)
    img = cv2.GaussianBlur(r.integers(0, 256, (60, 100, 3), np.uint8),
                           (0, 0), 1.5)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img
    return cv2.imencode(".jpeg", img)[1].tobytes()


def _little_endian_exif(jpeg_bytes: bytes, orientation: int) -> bytes:
    """APP1 Exif with an Intel (II) TIFF header, two IFD0 entries, the
    orientation second, inserted right after SOI."""
    entries = (struct.pack("<HHII", 0x010F, 2, 1, 0)          # Make
               + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0))
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 2) + \
        entries + struct.pack("<I", 0)
    body = b"Exif\0\0" + tiff
    return jpeg_bytes[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) \
        + body + jpeg_bytes[2:]


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_applied_as_cv2_imread(orientation, gray, tmp_path):
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    for k, data in enumerate((
            MF.with_exif_orientation(_small_jpeg(gray), orientation),
            _little_endian_exif(_small_jpeg(gray), orientation))):
        p = tmp_path / f"o{k}.jpeg"
        p.write_bytes(data)
        assert jpeg.exif_orientation(data) == orientation
        raw = cv2.imread(str(p), flag | cv2.IMREAD_IGNORE_ORIENTATION)
        want = cv2.imread(str(p), flag)
        got = jpeg.apply_orientation(raw, jpeg.exif_orientation(data))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_orientation_defaults_to_one():
    assert jpeg.exif_orientation(_small_jpeg()) == 1
    assert jpeg.exif_orientation(MF.with_exif_orientation(
        _small_jpeg(), 9)) == 1                       # out of range
    assert jpeg.exif_orientation(b"\xff\xd8\xff\xda") == 1
    data = (FIXTURES / "frame_2_exif6.jpeg").read_bytes()
    assert jpeg.exif_orientation(data) == 6


def test_fixtures_are_what_the_tool_writes(tmp_path):
    """The committed fixtures are the seeded tool's output, byte for
    byte, and cv2's decodes of them."""
    MF.write_fixtures(tmp_path)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(p.name for p in FIXTURES.iterdir())
    assert len(names) == 33
    for n in names:
        assert (tmp_path / n).read_bytes() == (FIXTURES / n).read_bytes(), n
    rot = cv2.imread(str(FIXTURES / "frame_2_exif6.jpeg"))
    assert rot.shape == (1280, 720, 3)


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """The 8 fixture frames as 2 sessions of camera JPEGs with their
    letterboxed masks (1536^2 PNG)."""
    root = tmp_path_factory.mktemp("jpeg_tree")
    for k in range(MF.N_FRAMES):
        sess = f"session_{k % 2:03d}"
        for sub in ("images", "masks"):
            (root / sub / sess).mkdir(parents=True, exist_ok=True)
        shutil.copy(FIXTURES / f"frame_{k}.jpeg",
                    root / "images" / sess / f"frame_{k}.jpeg")
        shutil.copy(FIXTURES / f"frame_{k}.mask.png",
                    root / "masks" / sess / f"frame_{k}.png")
    return root / "images", root / "masks"


@pytest.mark.parametrize("size", [512, 224])
def test_dataset_items_on_camera_jpegs_bit_equal_to_jax(jpeg_tree, size):
    ir, mr = jpeg_tree
    pj, pt = JP.gather_pairs(ir, mr), TP.gather_pairs(ir, mr)
    assert [p.astuple() for p in pt] == [p.astuple() for p in pj]
    assert len(pt) == MF.N_FRAMES
    dj = JDataset(pj, (size, size))
    dt = TDataset(pt, (size, size))
    assert dj._native is not None
    for i in range(len(pt)):
        (ji, jm), (ti, tm) = dj[i], dt[i]
        assert ti.shape == (size, size, 3) and tm.dtype == np.uint8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm.astype(np.float32), jm)
        assert 0.02 < tm.mean() < 0.5


@pytest.mark.parametrize("path", JPEGS, ids=lambda p: p.name)
def test_pseudo_label_frames_against_the_jax_reader(path):
    """load_frame (read, letterbox + resize) against
    cartseg_tpu/infer/pseudo_labels.py:166-172 at --img_size 512."""
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    want = cv2.resize(JG.letterbox_side_pad(
        cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), side_padding_ratio=0.1),
        (512, 512), interpolation=cv2.INTER_LINEAR)
    got = load_frame(path, 512, 0.1, "cpu")
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if path.name == "frame_2_exif6.jpeg":
        assert d.max() <= 1 and (d > 0).mean() <= 0.03
    else:
        assert d.max() == 0
    assert load_frame(Path(path).with_name("missing.jpeg"), 512, 0.1,
                      "cpu") is None
