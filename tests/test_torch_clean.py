"""Port parity: the mask-cleaning toolchain of cartseg_tpu_torch against
the JAX package on the CPU, bit for bit — the elliptical element
against cv2, morphology, hole fills, component statistics, the three
cleaners, the letterbox cut and its inverse, and the clean_masks,
remove_padding_from_masks and get_images CLIs on one tiny PNG tree.

Every mask that reaches a jitted JAX cleaner has one shape (MASK_HW),
so each compiles once per process.
"""

import importlib
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu import geometry as JG
from cartseg_tpu.postprocess import clean as JC
from cartseg_tpu.workloads import (clean_masks as j_clean_cli,
                                   get_images as j_images_cli,
                                   remove_padding_from_masks as j_unpad_cli)

from cartseg_tpu_torch import geometry as TG
from cartseg_tpu_torch.ops import connected_components as TCC
from cartseg_tpu_torch.ops import morphology as TM
from cartseg_tpu_torch.postprocess import clean as TC
from cartseg_tpu_torch.postprocess import unpad as TU
from cartseg_tpu_torch.utils import image_io
from cartseg_tpu_torch.workloads import (clean_masks as t_clean_cli,
                                         get_images as t_images_cli,
                                         remove_padding_from_masks as
                                         t_unpad_cli)
from torch_port_helpers import one_torch_thread  # noqa: F401

JM = importlib.import_module("cartseg_tpu.ops.morphology")
JCC = importlib.import_module("cartseg_tpu.ops.connected_components")
# the JAX functions a test calls image by image, jitted once for MASK_HW
_jit = {name: jax.jit(getattr(mod, name)) for mod, names in (
    (JM, ("fill_holes_from_border", "fill_small_holes")),
    (JCC, ("count_components", "keep_largest_component",
           "per_pixel_component_area", "per_pixel_component_any")))
    for name in names}

MASK_HW = (48, 48)
# original frames of the tree: 40 high, 50 wide -> side pad 5, a 60^2
# letterbox, masks stored resized to MASK_HW (content box 4..44 x 8..40)
FRAME_HW = (40, 50)


def _masks(seed: int, n: int, hw=MASK_HW) -> np.ndarray:
    """[n,H,W] bool: discs with holes, specks and noise in the padding."""
    r = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.ogrid[:H, :W]
    out = np.zeros((n, H, W), bool)
    for m in out:
        for _ in range(int(r.integers(1, 4))):
            cy, cx = r.integers(6, H - 6), r.integers(6, W - 6)
            rad = int(r.integers(3, 12))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
        m &= ~(r.random((H, W)) < 0.04)            # pinholes
        m |= r.random((H, W)) < 0.02               # specks
        m[:4, :] |= r.random((4, W)) < 0.3         # content in the padding
    return out


def _diagonal_hole() -> np.ndarray:
    """Background that reaches the border only through a diagonal step:
    a hole at 4-connectivity, not at 8."""
    m = np.ones(MASK_HW, bool)
    m[20:30, 20:30] = False
    m[0:5, 5:10] = False                            # a bay on the border
    m[5, 10] = False                                # one diagonal step away
    m[6:12, 11:15] = False
    return m


@pytest.mark.parametrize("ksize", range(1, 40))
def test_ellipse_kernel_is_cv2s(ksize):
    el = np.zeros((ksize, ksize), np.uint8)
    for dy, dx in TM.ellipse_kernel(ksize):
        el[dy + ksize // 2, dx + ksize // 2] = 1
    np.testing.assert_array_equal(
        el, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)))
    assert TM.ellipse_kernel(ksize) == JM.ellipse_kernel(ksize)


@pytest.mark.parametrize("shape", ["ellipse", "square"])
@pytest.mark.parametrize("op", ["dilate", "erode", "morph_open",
                                "morph_close"])
def test_morphology_bit_equal(op, shape):
    ms = _masks(1, 2, (23, 31))
    for k in (3, 4, 5, 7):
        got = getattr(TM, op)(torch.from_numpy(ms), k, shape).numpy()
        want = np.stack([np.asarray(getattr(JM, op)(jnp.asarray(m), k, shape))
                         for m in ms])
        np.testing.assert_array_equal(got, want, err_msg=f"{op} k={k}")


def test_morphology_rejects_unknown_shape():
    with pytest.raises(ValueError, match="shape"):
        TM.dilate(torch.ones(4, 4, dtype=torch.bool), 3, "cross")


@pytest.mark.parametrize("fill", ["fill_holes_from_border",
                                  "fill_small_holes"])
def test_hole_fills_bit_equal(fill):
    ms = np.concatenate([_masks(2, 3), _diagonal_hole()[None]])
    got = getattr(TM, fill)(torch.from_numpy(ms)).numpy()
    for g, m in zip(got, ms):
        np.testing.assert_array_equal(g, np.asarray(_jit[fill](
            jnp.asarray(m))))


def test_diagonal_hole_splits_the_two_fills():
    m = torch.from_numpy(_diagonal_hole())
    border4 = TM.fill_holes_from_border(m).numpy()
    small8 = TM.fill_small_holes(m, 0.1).numpy()
    # 4-connected: the diagonal step does not reach the border, so the
    # pocket fills; 8-connected it touches the border and stays open
    assert border4[8, 12] and not small8[8, 12]
    assert border4[25, 25] and small8[25, 25]


def test_component_statistics_bit_equal():
    ms = _masks(3, 3)
    t = torch.from_numpy(ms)
    np.testing.assert_array_equal(
        TCC.count_components(t).numpy(),
        [int(_jit["count_components"](jnp.asarray(m))) for m in ms])
    lab = TCC.connected_components(t)
    flags = torch.from_numpy(np.random.default_rng(0).random(ms.shape) < 0.01)
    area = TCC.per_pixel_component_area(lab).numpy()
    hit = TCC.per_pixel_component_any(lab, flags).numpy()
    for b in range(len(ms)):
        lb = jnp.asarray(lab[b].numpy())
        np.testing.assert_array_equal(
            area[b], np.asarray(_jit["per_pixel_component_area"](lb)))
        np.testing.assert_array_equal(hit[b], np.asarray(
            _jit["per_pixel_component_any"](lb, jnp.asarray(flags[b].numpy()))))


def test_keep_largest_component_tie_and_empty():
    tie = np.zeros(MASK_HW, bool)
    tie[30:34, 30:34] = True          # same area, later label
    tie[5:9, 5:9] = True              # first in raster order: kept
    ms = np.stack([tie, np.zeros(MASK_HW, bool), *_masks(4, 2)])
    got = TCC.keep_largest_component(torch.from_numpy(ms)).numpy()
    for g, m in zip(got, ms):
        np.testing.assert_array_equal(g, np.asarray(
            _jit["keep_largest_component"](jnp.asarray(m))))
    assert got[0, 6, 6] and not got[0, 31, 31]
    assert not got[1].any()


@pytest.mark.parametrize("name", ["clean_mask", "clean_mask_largest_component",
                                  "post_clean"])
def test_cleaners_bit_equal(name):
    ms = np.concatenate([_masks(5, 3), _diagonal_hole()[None]])
    got = getattr(TC, name)(torch.from_numpy(ms)).numpy()
    jfn = JC._post_clean_jit if name == "post_clean" else getattr(JC, name)
    args = (3, 7, 0.004) if name == "post_clean" else ()
    for g, m in zip(got, ms):
        np.testing.assert_array_equal(g, np.asarray(jfn(jnp.asarray(m),
                                                        *args)))


@pytest.mark.parametrize("orig,final", [((50, 40), (48, 48)),
                                        ((1280, 720), (512, 512)),
                                        ((1280, 720), (1536, 1536)),
                                        ((720, 1280), (300, 300)),
                                        ((33, 77), (17, 17))])
def test_letterbox_cut_and_inverse_bit_equal(orig, final):
    ow, oh = orig
    assert TG.calculate_content_boundaries(ow, oh, *final) == \
        JG.calculate_content_boundaries(ow, oh, *final)
    m = (np.random.default_rng(6).random(final[::-1]) * 255).astype(np.uint8)
    np.testing.assert_array_equal(TG.cut_mask_padding(m, ow, oh),
                                  JG.cut_mask_padding(m, ow, oh))
    np.testing.assert_array_equal(TG.remove_letterbox(m, ow, oh),
                                  JG.remove_letterbox(m, ow, oh))
    np.testing.assert_array_equal(
        TG.remove_letterbox(m, ow, oh, interpolation="linear"),
        JG.remove_letterbox(m, ow, oh, interpolation="linear"))


def test_linear_remove_letterbox_names_the_missing_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    m = np.zeros((48, 48), np.uint8)
    assert TG.remove_letterbox(m, 50, 40).shape == (40, 50)
    with pytest.raises(RuntimeError, match="cv2"):
        TG.remove_letterbox(m, 50, 40, interpolation="linear")


def test_make_overlay_equals_jax():
    from cartseg_tpu.postprocess import unpad as JU

    r = np.random.default_rng(7)
    img = r.integers(0, 255, (8, 9, 3), np.uint8)
    m = r.random((8, 9)) > 0.5
    np.testing.assert_array_equal(TU.make_overlay(img, m),
                                  JU.make_overlay(img, m))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """images/<s>/<k>.png frames of FRAME_HW, masks/<s>/<k>.png in the
    resized letterbox (MASK_HW), one mask without an image, plus a
    pseudo-label-style tree with overlay and prob renders."""
    root = tmp_path_factory.mktemp("clean_tree")
    r = np.random.default_rng(8)
    ms = _masks(9, 6)
    for i, m in enumerate(ms):
        sess = f"session_{i % 2}"
        (root / "images" / sess).mkdir(parents=True, exist_ok=True)
        (root / "masks" / sess).mkdir(parents=True, exist_ok=True)
        if i != 5:
            ext = ".PNG" if i == 4 else ".png"
            image_io.write_png(root / "images" / sess / f"f{i}{ext}",
                               r.integers(0, 255, FRAME_HW + (3,), np.uint8))
        image_io.write_png(root / "masks" / sess / f"f{i}.png",
                           m.astype(np.uint8) * 255)
        (root / "pseudo" / sess).mkdir(parents=True, exist_ok=True)
        image_io.write_png(root / "pseudo" / sess / f"f{i}.png",
                           m.astype(np.uint8) * 255)
        image_io.write_png(root / "pseudo" / sess / f"f{i}_overlay_512.png",
                           m.astype(np.uint8))
    return root


def _pngs(root):
    """{relative path: decoded pixels} of every PNG under root."""
    return {p.relative_to(root): image_io.decode_png(p.read_bytes())
            for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("mode", ["complete", "holes_largest",
                                  "largest_only"])
def test_clean_masks_cli_bit_equal(tree, tmp_path, mode):
    common = ["--masks_root", str(tree / "masks"), "--images_root",
              str(tree / "images"), "--mode", mode]
    j_clean_cli.main(common + ["--out_root", str(tmp_path / "j")])
    n = t_clean_cli.main(common + ["--out_root", str(tmp_path / "t"),
                                   "--device", "cpu"])
    want, got = _pngs(tmp_path / "j"), _pngs(tmp_path / "t")
    assert n == 6 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    if mode == "complete":
        x0, y0, x1, y1 = TG.calculate_content_boundaries(50, 40, 48, 48)
        out = got[next(iter(got))]
        assert not out[:y0].any() and not out[y1:].any()
        assert not out[:, :x0].any() and not out[:, x1:].any()


def test_remove_padding_cli_bit_equal(tree, tmp_path):
    common = ["--masks_root", str(tree / "masks"), "--images_root",
              str(tree / "images")]
    j_unpad_cli.main(common + ["--out_root", str(tmp_path / "j"),
                               "--overlays", str(tmp_path / "ovj")])
    n = t_unpad_cli.main(common + ["--out_root", str(tmp_path / "t"),
                                   "--overlays", str(tmp_path / "ovt"),
                                   "--device", "cpu"])
    assert n == 4          # f4's image is .PNG, f5 has none
    for a, b in (("j", "t"), ("ovj", "ovt")):
        want, got = _pngs(tmp_path / a), _pngs(tmp_path / b)
        assert list(got) == list(want) and len(got) == 4
        for k in want:
            assert got[k].shape[:2] == FRAME_HW
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("cmd", ["copy-images", "copy-masks"])
def test_get_images_cli_equal(tree, tmp_path, cmd):
    if cmd == "copy-images":
        args = [cmd, "--masks_root", str(tree / "masks"), "--images_root",
                str(tree / "images"), "--out_root"]
    else:
        args = [cmd, "--src_root", str(tree / "pseudo"), "--dst_root"]
    j_images_cli.main(args + [str(tmp_path / "j")])
    n = t_images_cli.main(args + [str(tmp_path / "t")])
    want = {p.relative_to(tmp_path / "j"): p.read_bytes()
            for p in (tmp_path / "j").rglob("*") if p.is_file()}
    got = {p.relative_to(tmp_path / "t"): p.read_bytes()
           for p in (tmp_path / "t").rglob("*") if p.is_file()}
    assert got == want and n == len(got) == (5 if cmd == "copy-images"
                                             else 6)


def test_cleaning_cuda_is_refused_without_a_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_clean_cli.main(["--masks_root", str(tree / "masks"),
                          "--out_root", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="cuda"):
        t_unpad_cli.main(["--masks_root", str(tree / "masks"),
                          "--images_root", str(tree / "images"),
                          "--out_root", str(tmp_path / "o")])


def test_port_imports_no_opencv_pil_or_pandas_at_import_time():
    """AST scan of every module's top level (statements outside any
    function): cv2, PIL and pandas are imported, where at all, inside the
    functions that need them."""
    import ast
    from pathlib import Path

    import cartseg_tpu_torch

    pkg = Path(cartseg_tpu_torch.__file__).parent
    banned = {"cv2", "PIL", "pandas"}
    for f in sorted(pkg.rglob("*.py")):
        tree = ast.parse(f.read_text())
        stack = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                names = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = {node.module.split(".")[0]}
            else:
                names = set()
            assert not names & banned, f"{f.relative_to(pkg)} imports {names}"
            stack.extend(ast.iter_child_nodes(node))
