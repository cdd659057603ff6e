"""Port parity: the pseudo-labeller's contour overlays and mining's
preview panels without OpenCV (cartseg_tpu_torch.native's contours.cpp,
postprocess/overlay.py) against cv2 and the JAX package's `_overlay`
and `_save_previews`, on the CPU.

Tolerances: none. The contours are cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)'s points in cv2's order, the drawings, the JET
table and the written panels bit-equal to cv2's, on masks with several
blobs, holes, islands in holes, one-pixel parts, lines and parts that
touch the border, and on noise.
"""

import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from cartseg_tpu.infer import mining as JMi  # noqa: E402
from cartseg_tpu.infer import pseudo_labels as JP  # noqa: E402

from cartseg_tpu_torch import native as TN  # noqa: E402
from cartseg_tpu_torch.infer import engine as TE  # noqa: E402
from cartseg_tpu_torch.infer import mining as TMi  # noqa: E402
from cartseg_tpu_torch.infer import pseudo_labels as TP  # noqa: E402
from cartseg_tpu_torch.postprocess.overlay import (  # noqa: E402
    JET_RGB, apply_colormap_jet, draw_external_contours)
from cartseg_tpu_torch.utils import image_io  # noqa: E402
from cartseg_tpu_torch.utils.synthetic import frame  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_helpers import port_effnet_and_jax_twin  # noqa: E402

KINDS = ("blobs", "holes", "pixels", "border", "noise", "lines", "empty",
         "full")


def make_mask(kind: str, hw, seed: int) -> np.ndarray:
    """A 0/1 uint8 mask of `kind`: disks (some past the border), disks
    with holes and islands in the holes, one-pixel parts, parts that
    touch the border, noise, one-pixel lines, nothing, everything."""
    h, w = hw
    r = np.random.default_rng(seed)
    yy, xx = np.ogrid[:h, :w]
    m = np.zeros((h, w), bool)

    def disk(cy, cx, rad):
        return (yy - cy) ** 2 + (xx - cx) ** 2 < rad * rad

    if kind in ("blobs", "holes"):
        for _ in range(6):
            cy, cx = r.integers(-h // 8, h + h // 8), r.integers(0, w)
            rad = int(r.integers(3, max(4, min(h, w) // 4)))
            m |= disk(cy, cx, rad)
            if kind == "holes":
                m &= ~disk(cy, cx, rad // 2)
                m |= disk(cy, cx, rad // 5)          # an island in the hole
    elif kind == "pixels":
        m[r.integers(0, h, 40), r.integers(0, w, 40)] = True
        m[h // 2, :] = False
        m[h // 2, 3:9] = True
    elif kind == "border":
        m[:3, :] = True
        m[:, -2:] = True
        m |= disk(h - 1, 0, min(h, w) // 3)
        m[h // 2, w // 2] = True
    elif kind == "noise":
        m = r.random((h, w)) < 0.45
    elif kind == "lines":
        m[h // 3, 2:w - 2] = True
        m[2:h - 2, w // 3] = True
        np.fill_diagonal(m[h // 2:, w // 2:], True)
    elif kind == "full":
        m[:] = True
    return m.astype(np.uint8)


@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (512, 512)])
@pytest.mark.parametrize("kind", KINDS)
def test_external_contours_equal_cv2(kind, hw):
    m = make_mask(kind, hw, KINDS.index(kind) + hw[0])
    want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    got = TN.find_external_contours(m)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.reshape(-1, 2))


@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (512, 512)])
@pytest.mark.parametrize("kind", KINDS)
def test_overlay_bit_equal_jax_without_cv2(kind, hw, monkeypatch):
    m = make_mask(kind, hw, KINDS.index(kind) + hw[1])
    rgb = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), np.uint8)
    want = JP._overlay(rgb, m)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(TP._overlay(rgb, m), want)


@pytest.mark.parametrize("thickness", [3, 4, 7])
def test_draw_contours_thicker_and_other_colours_equal_cv2(thickness):
    m = make_mask("holes", (96, 120), thickness)
    rgb = np.random.default_rng(thickness).integers(0, 256, (96, 120, 3),
                                                    np.uint8)
    cnts, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    want = rgb.copy()
    cv2.drawContours(want, cnts, -1, (9, 200, 77), thickness)
    np.testing.assert_array_equal(
        draw_external_contours(rgb, m, (9, 200, 77), thickness), want)


def test_draw_refuses_thin_lines_and_bad_colours():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="thickness"):
        TN.draw_contours(img, [np.zeros((1, 2), np.int32)], (1, 2, 3), 1)
    with pytest.raises(ValueError, match="colour"):
        TN.draw_contours(img, [np.zeros((1, 2), np.int32)], (1, 2), 2)


def test_jet_on_every_value_equals_cv2():
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    bgr = cv2.applyColorMap(v, cv2.COLORMAP_JET)
    np.testing.assert_array_equal(apply_colormap_jet(v), bgr[..., ::-1])
    assert JET_RGB.shape == (256, 3)


# ------------------------------------------------ the workloads' outputs

S = 96
# 180 x 240 frames: side pad 24, a 288^2 letterbox, 3 x S, where the
# JAX loader (cv2) and the port's native loader are bit-equal by design
FRAME_HW = (180, 240)


@pytest.fixture(scope="module")
def png_frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlay_frames")
    r = np.random.default_rng(21)
    paths = []
    for i in range(4):
        p = root / f"session_{i % 2}" / f"f{i}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        image_io.write_png(p, frame(r, FRAME_HW))
        paths.append(p)
    return root, paths


def _probs(kind: str, seed: int) -> np.ndarray:
    """Probabilities whose > 0.5 region is make_mask(kind), with a smooth
    ramp on both sides so the heat map has every colour."""
    m = make_mask(kind, (S, S), seed).astype(np.float32)
    ramp = np.linspace(0.0, 0.49, S, dtype=np.float32)[None, :]
    return (0.5 * m + ramp + 0.005).astype(np.float32)


def test_mining_previews_bit_equal_jax_without_cv2(png_frames, tmp_path,
                                                   monkeypatch):
    import pandas as pd

    _, paths = png_frames
    kinds = ("holes", "border", "pixels", "noise")
    by_frame = {}

    def key(img):
        return np.asarray(img).tobytes()

    for i, p in enumerate(paths):
        img = TP.load_frame(p, S, 0.1, "cpu")
        by_frame[key(img)] = _probs(kinds[i], 40 + i)

    def jax_fwd(batch):
        probs = np.stack([by_frame[key(x)] for x in np.asarray(batch)])
        return probs, probs

    def port_fwd(batch):
        probs = torch.from_numpy(np.stack([by_frame[key(x)]
                                           for x in batch.numpy()]))
        return probs, probs

    df = pd.DataFrame({"path": [str(p) for p in paths]})
    JMi._save_previews(df, jax_fwd, JMi.MiningConfig(img_size=S,
                                                     batch_size=3),
                       tmp_path / "j", log=lambda *a: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    TMi._save_previews([{"path": str(p)} for p in paths], port_fwd,
                       TMi.MiningConfig(img_size=S), tmp_path / "t", "cpu",
                       log=lambda *a: None)
    names = sorted(q.name for q in (tmp_path / "j" / "previews").iterdir())
    assert names == sorted(q.name for q in
                           (tmp_path / "t" / "previews").iterdir())
    assert len(names) == 4
    for n in names:
        want = cv2.imread(str(tmp_path / "j" / "previews" / n))[..., ::-1]
        got = image_io.decode_png((tmp_path / "t" / "previews" / n)
                                  .read_bytes())
        assert got.shape == (S, 3 * S, 3)
        np.testing.assert_array_equal(got, want, err_msg=n)


def test_pseudo_label_overlays_without_cv2(png_frames, tmp_path,
                                           monkeypatch):
    """create_pseudo_labels' --overlay_dir on the CPU with cv2 refused:
    one overlay a frame, each the JAX `_overlay` of the port's letterboxed
    frame and the mask the workload wrote."""
    root, paths = png_frames
    model, _, _ = port_effnet_and_jax_twin(seed=50)
    member = TE.EnsembleMember(TE.prepare_model(model, "cpu"), 1.0, 0.5)
    fwd = TE.ensemble_probs_fn([member], TP.IMAGENET_MEAN, TP.IMAGENET_STD,
                               tta_flip=True)
    x = np.stack([TP.load_frame(p, S, 0.1, "cpu") for p in paths])
    p0, p1 = fwd(torch.from_numpy(x))
    threshold = float(((p0 + p1) / 2).median())
    qc = TP.QCThresholds(min_fg_area=0, max_fg_area=1, min_fg_conf=0,
                         max_mean_entropy=10, min_tta_iou=0, min_edge_hit=0)
    cfg = TP.PseudoLabelConfig(
        images_root=str(root), out_dir=str(tmp_path / "pseudo"),
        overlay_dir=str(tmp_path / "overlays"), img_size=S,
        threshold=threshold, batch_size=4, qc=qc, min_area_frac=0.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = TP.generate_pseudo_labels([member], cfg, device="cpu",
                                    log=lambda *a: None)
    monkeypatch.delitem(sys.modules, "cv2")
    assert out["accepted"] == len(paths)
    structured = 0
    for p, img in zip(paths, x):
        rel = p.relative_to(root)
        mask = image_io.decode_png(
            (tmp_path / "pseudo" / rel.parent / f"{p.stem}.png")
            .read_bytes())
        got = image_io.decode_png(
            (tmp_path / "overlays" / f"{p.stem}_overlay_512.png")
            .read_bytes())
        np.testing.assert_array_equal(got, JP._overlay(img, mask // 255))
        structured += 0 < mask.mean() < 255
    assert structured >= 2
