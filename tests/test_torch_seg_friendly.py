"""Port parity: the annotation tool's `seg_friendly` without OpenCV
(cartseg_tpu_torch.tools.annotate.seg_friendly and its stages in
ops/filters.py, ops/color.py and ops/clahe.py) against the cv2 calls of
cartseg_tpu/tools/annotate.py:44-58, on the CPU.

Tolerances: none, except for the bilateral filter. Every other stage is
bit-equal to its cv2 call on every input tried: convertScaleAbs and
addWeighted over all byte values, both 8-bit Lab conversions over all
2^24 inputs, the blurs and CLAHE on noise and odd sizes. The bilateral
filter computes cv2's float32 arithmetic in cv2's order, but the
installed cv2 hands it to IPP, whose quotient is not always the
correctly rounded one: on values whose quotient lies within 1e-5 of a
half it can round the other way. Measured: 0 such values on the inputs
below; on the eight 1280x720 fixture frames 0 to 2 values of 2.76M a
frame, each 1 off (python -m
cartseg_tpu_torch.tools.seg_friendly_against_cv2). The bound these tests
hold the filter to is that: at most 1 off, on at most 1 value in 10^5.
"""

import sys
from fractions import Fraction as Fr

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from cartseg_tpu.tools import annotate as JA  # noqa: E402

from cartseg_tpu_torch.ops import color as C  # noqa: E402
from cartseg_tpu_torch.ops.clahe import clahe_u8  # noqa: E402
from cartseg_tpu_torch.ops.filters import (_fma_f32, bilateral_u8,  # noqa
                                           gaussian_blur_u8)
from cartseg_tpu_torch.tools import annotate as TA  # noqa: E402
from cartseg_tpu_torch.tools.make_jpeg_fixtures import OUT as FIXTURES  # noqa
from cartseg_tpu_torch.utils.image_io import decode_png  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401

# the bilateral filter's bound against cv2 (IPP): |d| <= 1 on at most
# this share of the values
BILATERAL_SHARE = 1e-5


def _noise(shape, seed, smooth=0.0):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return cv2.GaussianBlur(img, (0, 0), smooth) if smooth else img


def _frame_crop():
    """A 128 x 192 crop of fixture frame 0's cv2 decode (the cart's
    handle and basket), BGR."""
    rgb = decode_png((FIXTURES / "frame_0.cv2.png").read_bytes())
    return np.ascontiguousarray(rgb[200:328, 400:592, ::-1])


def _within_bilateral_bound(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).sum() <= BILATERAL_SHARE * d.size


# ------------------------------------------------------------ stages

@pytest.mark.parametrize("shape,seed,smooth", [
    ((48, 64, 3), 0, 0.0), ((37, 50, 3), 1, 0.0), ((64, 80, 3), 2, 2.0),
    ((9, 5, 3), 3, 0.0), ((1, 11, 3), 4, 0.0), ((2, 3, 3), 5, 0.0)])
def test_bilateral_against_cv2(shape, seed, smooth):
    img = _noise(shape, seed, smooth)
    _within_bilateral_bound(bilateral_u8(torch.from_numpy(img)).numpy(),
                            cv2.bilateralFilter(img, 15, 100, 15))


def test_bilateral_on_a_frame_crop_against_cv2():
    img = _frame_crop()
    _within_bilateral_bound(bilateral_u8(torch.from_numpy(img)).numpy(),
                            cv2.bilateralFilter(img, 15, 100, 15))


@pytest.mark.parametrize("d,sc,ss", [(5, 30.0, 3.0), (9, 75.0, 75.0)])
def test_bilateral_other_parameters_against_cv2(d, sc, ss):
    img = _noise((40, 56, 3), d)
    _within_bilateral_bound(
        bilateral_u8(torch.from_numpy(img), d, sc, ss).numpy(),
        cv2.bilateralFilter(img, d, sc, ss))


def test_bilateral_refuses_other_layouts():
    with pytest.raises(ValueError, match="H, W, 3"):
        bilateral_u8(torch.zeros((3, 8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="H, W, 3"):
        bilateral_u8(torch.zeros((8, 8, 3), dtype=torch.float32))


def _round_f32(e) -> np.float32:
    """The Fraction e rounded to float32, to nearest, ties to even."""
    lo = np.float32(float(e))
    if Fr(float(lo)) > e:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    dl, dh = e - Fr(float(lo)), Fr(float(hi)) - e
    even = lo.view(np.int32) % 2 == 0
    return lo if dl < dh or (dl == dh and even) else hi


def test_fma_f32_is_one_rounding():
    """The plain lane's fused multiply-add (float64 sum and its TwoSum
    error) against a * b + c rounded once, exactly: on random values and
    on four sums that lie a hair above or below a float32 tie, where the
    float64 sum lands on the tie itself and rounding it again to float32
    would go the wrong way in two of them."""
    r = np.random.default_rng(7)
    a = r.integers(0, 256, 2000).astype(np.float32)
    b = (r.random(2000) * 2.0 ** r.integers(-30, 1, 2000)).astype(np.float32)
    c = (r.random(2000) * 2.0 ** r.integers(-5, 21, 2000)).astype(np.float32)
    # c + a * b within 2^-33 of c + 2^-4, half of c's ulp at 2^20
    lo, hi = np.float32(2.0 ** 20), np.float32(2.0 ** 20 + 0.125)
    b59 = np.int32(982178035).view(np.float32)   # 59 * b59 just above 2^-4
    b77 = np.int32(978634619).view(np.float32)   # 77 * b77 just below
    a = np.concatenate([a, np.float32([59, 77, 59, 77])])
    b = np.concatenate([b, [b59, b77, b59, b77]]).astype(np.float32)
    c = np.concatenate([c, [lo, lo, hi, hi]]).astype(np.float32)
    got = _fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fr(float(x)) * Fr(float(y)) + Fr(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-4:], [hi, lo, hi + np.float32(0.125),
                                             hi])
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-4:] != got[-4:]).sum() == 2


@pytest.mark.parametrize("sigma", [1.5, 1.0])
@pytest.mark.parametrize("shape", [(48, 64, 3), (37, 50, 3), (5, 7, 3)])
def test_gaussian_blur_three_channels_bit_equal_cv2(shape, sigma):
    img = _noise(shape, shape[0])
    got = gaussian_blur_u8(torch.from_numpy(img).permute(2, 0, 1), sigma)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(),
                                  cv2.GaussianBlur(img, (0, 0), sigma))


@pytest.mark.parametrize("alpha", [1.3, 0.7, 2.5])
def test_convert_scale_abs_bit_equal_cv2_on_every_byte(alpha):
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        C.convert_scale_abs(torch.from_numpy(v), alpha).numpy(),
        cv2.convertScaleAbs(v, alpha=alpha, beta=0))


def test_add_weighted_bit_equal_cv2_on_every_pair():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(
        C.add_weighted(torch.from_numpy(a), 1.5, torch.from_numpy(b),
                       -0.5, 0.0).numpy(),
        cv2.addWeighted(a, 1.5, b, -0.5, 0))


def _all_triples(part: int) -> np.ndarray:
    """A quarter of the 2^24 byte triples as a [1024, 4096, 3] image."""
    v = np.arange(part << 22, (part + 1) << 22, dtype=np.uint32)
    t = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    return t.astype(np.uint8).reshape(1024, 4096, 3)


@pytest.mark.parametrize("direction", ["bgr_to_lab", "lab_to_bgr"])
def test_lab_bit_equal_cv2_on_all_2_24_inputs(direction):
    fn, code = ((C.bgr_to_lab_u8, cv2.COLOR_BGR2LAB)
                if direction == "bgr_to_lab"
                else (C.lab_to_bgr_u8, cv2.COLOR_LAB2BGR))
    for part in range(4):
        x = _all_triples(part)
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(),
                                      cv2.cvtColor(x, code))


@pytest.mark.parametrize("shape", [(48, 64), (37, 50), (33, 64), (64, 31),
                                   (17, 9), (5, 3), (1, 1), (720, 1280)])
@pytest.mark.parametrize("clip,tiles", [(4.0, (4, 4)), (2.0, (8, 3)),
                                        (40.0, (2, 5))])
def test_clahe_bit_equal_cv2(shape, clip, tiles):
    for k, L in enumerate((_noise(shape, 1),
                           cv2.GaussianBlur(_noise(shape, 2), (0, 0), 3),
                           (_noise(shape, 3) // 128 * 100).astype(np.uint8))):
        np.testing.assert_array_equal(
            clahe_u8(torch.from_numpy(L), clip, tiles).numpy(),
            cv2.createCLAHE(clip, tiles).apply(L), err_msg=str(k))


# ------------------------------------------------------------ the chain

@pytest.fixture
def no_cv2_in_the_port(monkeypatch):
    """`import cv2` fails for the port (and find_spec finds nothing); this
    module and the JAX package keep the cv2 they imported."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _jax(img):
    # the JAX function imports cv2 where it runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", cv2)
        return JA.seg_friendly(img)


@pytest.mark.parametrize("src", ["noise", "smooth noise", "frame crop",
                                 "odd size"])
def test_seg_friendly_bit_equal_jax_without_cv2(src, no_cv2_in_the_port):
    img = {"noise": lambda: _noise((48, 64, 3), 2),
           "smooth noise": lambda: _noise((64, 96, 3), 3, 1.5),
           "frame crop": _frame_crop,
           "odd size": lambda: _noise((37, 53, 3), 4, 1.0)}[src]()
    np.testing.assert_array_equal(TA.seg_friendly(img), _jax(img))


def test_stored_seg_friendly_is_the_jax_chain():
    """frame_0.seg_friendly.cv2.png (what chip_smoke.py holds the card's
    seg_friendly against) is the JAX function of frame 0's stored cv2
    decode."""
    rgb = decode_png((FIXTURES / "frame_0.cv2.png").read_bytes())
    want = decode_png((FIXTURES / "frame_0.seg_friendly.cv2.png")
                      .read_bytes())
    np.testing.assert_array_equal(
        JA.seg_friendly(np.ascontiguousarray(rgb[..., ::-1]))[..., ::-1],
        want)
