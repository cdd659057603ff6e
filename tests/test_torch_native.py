"""Port parity: cartseg_tpu_torch.native (its own copies of edt.cpp and
preproc.cpp, built with the JAX package's flags) against
cartseg_tpu.native, bit for bit, and the port's letterbox + resize and
mask resize against cv2, as the JAX pseudo-labeller and dataset use it.

Tolerances: none between the two native libraries (the same sources and
flags, built on one machine). The native bilinear resize against
letterbox_side_pad + cv2 INTER_LINEAR (the JAX pseudo-labeller's path):
bit-equal where the letterbox is an integer multiple of the output
(1280x720 -> 512^2, a frame whose letterbox is exactly 1024^2 -> 512^2,
where cv2 takes its INTER_AREA path); elsewhere at most 1 LSB on at most
8 % of the values when downscaling (measured 2.7-6.9 %: cv2 weighs in
11-bit fixed point), and on an upscale whose content touches the canvas
edge (300x400 unlettered -> 512^2) the edge rows differ by up to 20 (cv2
replicates the edge, the native loader pads). The mask resize equals
cv2 INTER_NEAREST exactly.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cartseg_tpu import geometry as JG  # noqa: E402
from cartseg_tpu import native as JN  # noqa: E402

from cartseg_tpu_torch import geometry as TG  # noqa: E402
from cartseg_tpu_torch import native as TN  # noqa: E402
from cartseg_tpu_torch.data.dataset import resize_nearest  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_helpers import pinned_jax_native  # noqa: E402,F401

# (frame h, w, output side): camera frames to 512^2 and 224^2, an
# upscale, and a frame whose letterbox is exactly 1024^2 (854 + 2 * 85)
CASES = [(720, 1280, 512), (720, 1280, 224), (300, 400, 512),
         (1024, 854, 512)]


def _frame(h, w, seed, smooth):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 2.0) if smooth else img


@pytest.mark.parametrize("ratio", [0.1, 0.0])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("h,w,S", CASES)
def test_letterbox_resize_bit_equal_to_jax_native(h, w, S, smooth, ratio):
    img = _frame(h, w, h + w + S, smooth)
    np.testing.assert_array_equal(
        TN.letterbox_resize(img, (S, S), ratio),
        JN.letterbox_resize(img, (S, S), ratio))
    pad = (7, 8, 9)
    np.testing.assert_array_equal(
        TN.letterbox_resize(img, (S, S // 2), ratio, pad),
        JN.letterbox_resize(img, (S, S // 2), ratio, pad))


@pytest.mark.parametrize("src,dst", [((1536, 1536), (512, 512)),
                                     ((1536, 1536), (224, 224)),
                                     ((480, 640), (224, 224)),
                                     ((77, 101), (300, 200))])
def test_resize_nearest_bit_equal_to_jax_native(src, dst):
    m = np.random.default_rng(src[0]).integers(0, 256, src, np.uint8)
    np.testing.assert_array_equal(TN.resize_nearest(m, dst),
                                  JN.resize_nearest(m, dst))


def test_edt_bit_equal_to_jax_native():
    r = np.random.default_rng(3)
    seeds = r.random((96, 128)) > 0.98
    seeds[0, 0] = True
    np.testing.assert_array_equal(TN.edt_exact(seeds), JN.edt_exact(seeds))
    m = r.random((64, 80)) > 0.3
    np.testing.assert_array_equal(TN.distance_transform_edt(m),
                                  JN.distance_transform_edt(m))
    from scipy import ndimage
    np.testing.assert_allclose(TN.distance_transform_edt(m),
                               ndimage.distance_transform_edt(m), atol=1e-4)


@pytest.mark.parametrize("h,w,S", CASES)
def test_pseudo_label_resize_against_the_jax_reader(h, w, S):
    """geometry.letterbox_resize against letterbox_side_pad + cv2
    INTER_LINEAR (cartseg_tpu/infer/pseudo_labels.py:166-172), at the
    stated |d| (module docstring)."""
    img = _frame(h, w, h * w + S, True)
    got = TG.letterbox_resize(img, S, 0.1)
    want = cv2.resize(JG.letterbox_side_pad(img), (S, S),
                      interpolation=cv2.INTER_LINEAR)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if (h, w, S) in ((720, 1280, 512), (1024, 854, 512)):
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 0.08


def test_unlettered_upscale_differs_only_at_the_canvas_edge():
    """300x400 without side padding touches the canvas's left and right
    edges; upscaled, the native loader blends those columns with the pad
    where cv2 replicates them."""
    img = _frame(300, 400, 5, True)
    got = TN.letterbox_resize(img, (512, 512), 0.0)
    want = cv2.resize(JG.letterbox_side_pad(img, side_padding_ratio=0.0),
                      (512, 512), interpolation=cv2.INTER_LINEAR)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d[:, 1:-1].max() <= 1 and 1 < d.max() <= 20


@pytest.mark.parametrize("src", [(1536, 1536), (2304, 2304), (76, 100),
                                 (720, 1280), (3000, 513), (7, 5)])
@pytest.mark.parametrize("dst", [(512, 512), (224, 224), (100, 33),
                                 (513, 17)])
def test_mask_resize_equals_cv2_nearest(src, dst):
    m = np.random.default_rng(sum(src) + sum(dst)).integers(
        0, 256, src, np.uint8)
    np.testing.assert_array_equal(
        resize_nearest(m, dst),
        cv2.resize(m, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void f() { this is not C++ }\n")
    monkeypatch.setattr(TN, "SOURCES", (bad,))
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.build()
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TN.build()
