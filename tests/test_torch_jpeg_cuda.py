"""The card's JPEG reader (utils/jpeg.py, nvJPEG) against cv2's decode of
the same files, stored beside them in cartseg_tpu_torch/tools/
jpeg_fixtures/ (tools/make_jpeg_fixtures.py). Every test here is marked
`cuda` and skips without a card.

This file imports no JAX and needs no OpenCV, so it runs on the GPU
machine without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_jpeg_cuda.py

Tolerance: the mean |nvJPEG - cv2| of a fixture at most 1.0 LSB, shapes
equal (the EXIF Orientation 6 frame included). The two decoders need not
agree bit for bit: libjpeg-turbo (cv2) upsamples 4:2:0 chroma with its
triangle filter and converts YCbCr to RGB in its own fixed point, and
nvJPEG's IDCT and upsampling are its own.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from cartseg_tpu_torch.utils import image_io
from torch_port_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

FIXTURES = Path(__file__).resolve().parents[1] / \
    "cartseg_tpu_torch" / "tools" / "jpeg_fixtures"
JPEGS = sorted(p.name for p in FIXTURES.glob("*.jpeg"))
MEAN_TOL = 1.0


def _stored(name: str) -> np.ndarray:
    return image_io.decode_png((FIXTURES / name).read_bytes())


def test_every_fixture_is_listed():
    assert len(JPEGS) == 12


@pytest.mark.parametrize("name", JPEGS)
def test_nvjpeg_rgb_within_one_lsb_of_cv2(cuda_device, name):
    got = image_io.read_rgb(FIXTURES / name, cuda_device)
    want = _stored(name.replace(".jpeg", ".cv2.png"))
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{name}: max |d| {d.max()}, mean |d| {d.mean():.4f}")
    assert d.mean() <= MEAN_TOL


def test_nvjpeg_gray_is_cv2_luma(cuda_device):
    got = image_io.read_gray(FIXTURES / "frame_0.jpeg", cuda_device)
    want = _stored("frame_0.cv2gray.png")
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"frame_0 luma: max |d| {d.max()}, mean |d| {d.mean():.4f}")
    assert d.mean() <= MEAN_TOL


def test_threads_decode_with_their_own_states(cuda_device):
    """Eight threads decode the fixtures at once, each on its own nvJPEG
    state and stream; every decode equals the one made alone."""
    alone = {n: image_io.read_rgb(FIXTURES / n, cuda_device) for n in JPEGS}
    got, errors = {}, []

    def work(i):
        try:
            for n in JPEGS[i:] + JPEGS[:i]:
                got[(i, n)] = image_io.read_rgb(FIXTURES / n, cuda_device)
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for (i, n), img in got.items():
        np.testing.assert_array_equal(img, alone[n])


def test_undecodable_file_raises_with_its_name(cuda_device, tmp_path):
    bad = tmp_path / "broken.jpeg"
    bad.write_bytes((FIXTURES / "frame_0.jpeg").read_bytes()[:100])
    with pytest.raises(RuntimeError, match="broken.jpeg"):
        image_io.read_rgb(bad, cuda_device)
    assert image_io.read_rgb(tmp_path / "missing.jpeg", cuda_device) is None
