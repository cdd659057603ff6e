"""Port parity: the annotation tools (cartseg_tpu_torch/tools/annotate.py,
ops/filters.py, the three labelling workloads) against the JAX package's
cv2-backed module.

Bit-equal (the port reproduces cv2 without OpenCV): the Gaussian blur's
taps and output, `smooth_mask` (k 3/5/7/9, iters 1/2), `fill_holes`,
the brush (r 1-17, at the edges), the proposal resize, the session
(with a fake SAM) and the PNGs it saves, `run_ui`'s saved masks and
skip markers through a proxy cv2 whose window calls replay a script.
`Proposer.propose` against `TPUProposer` on the same effnet-b0 weights:
probabilities within 1e-4 (tests/test_torch_infer.py's tolerance), the
mask equal wherever |p - threshold| > 1e-4.

The reference's embedding race is pinned: JAX's `run_ui` injects
`sam.features` while its worker goes on calling `set_image` on the same
predictor; the port's session decodes against its own item's embedding.
"""

import csv
import sys
import threading
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.infer import engine as JE
from cartseg_tpu.tools import annotate as JA
from cartseg_tpu.workloads import create_hard_masks as j_hard
from cartseg_tpu.workloads import create_more_specific_data as j_more
from cartseg_tpu.workloads import create_testset as j_test

from cartseg_tpu_torch.models import sam as tsam
from cartseg_tpu_torch.ops import filters
from cartseg_tpu_torch.tools import annotate as TA
from cartseg_tpu_torch.utils import image_io
from cartseg_tpu_torch.utils.synthetic import frame
from cartseg_tpu_torch.workloads import create_hard_masks as t_hard
from cartseg_tpu_torch.workloads import create_more_specific_data as t_more
from cartseg_tpu_torch.workloads import create_testset as t_test
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                port_effnet_and_jax_twin,
                                sam_official_state_dict)

PROBS_TOL = 1e-4


def _masks(n, hw=(96, 128), seed=0):
    """Seeded masks of filled ellipses with elliptical holes and 3 % salt
    noise, uint8 {0,255}."""
    r = np.random.default_rng(seed)
    H, W = hw
    out = []
    for _ in range(n):
        m = np.zeros((H, W), np.uint8)
        for _ in range(4):
            c = (int(r.integers(0, W)), int(r.integers(0, H)))
            a, b = (int(v) for v in r.integers(5, 30, 2))
            cv2.ellipse(m, c, (a, b), float(r.integers(0, 180)), 0, 360,
                        255, -1)
            cv2.ellipse(m, c, (a // 2, b // 2), 0, 0, 360, 0, -1)
        m[r.random((H, W)) < 0.03] ^= 255
        out.append(m)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- filters

def _ed_taps(kernel: np.ndarray) -> list:
    """cv2's error-diffused 1/256 rounding applied to cv2's own kernel."""
    n = len(kernel)
    taps, err = [0] * n, 0.0
    for i in range(n // 2):
        adj = kernel[i] * 256.0 + err
        v = round(adj)
        err = adj - v
        taps[i] = taps[n - 1 - i] = v
    taps[n // 2] = 256 - 2 * sum(taps[:n // 2])
    return taps


@pytest.mark.parametrize("sigma", [1.5, 2.5, 3.5, 4.5, 1.0])
def test_blur_taps_equal_cv2(sigma):
    """The session's sigmas (k / 2 for k = 3, 5, 7, 9): the port's
    float64 kernel against cv2.getGaussianKernel, and its fixed-point
    taps against the same rounding of cv2's."""
    ks = filters.ksize_for(sigma)
    want = cv2.getGaussianKernel(ks, sigma, cv2.CV_64F).ravel()
    np.testing.assert_allclose(filters.gaussian_kernel(ks, sigma), want,
                               rtol=1e-14)
    assert list(filters.fixed_point_taps(sigma)) == _ed_taps(want)
    assert sum(filters.fixed_point_taps(sigma)) == 256


@pytest.mark.parametrize("sigma", [1.5, 2.5, 3.5, 4.5])
def test_gaussian_blur_u8_bit_equal_cv2(sigma):
    r = np.random.default_rng(int(sigma * 10))
    imgs = _masks(3, seed=int(sigma)) + [
        r.integers(0, 256, (61, 83)).astype(np.uint8),
        r.integers(0, 256, (5, 3)).astype(np.uint8)]
    for img in imgs:
        want = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
        got = filters.gaussian_blur_u8(_t(img), sigma).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- image ops

@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_smooth_mask_bit_equal_jax(k, iters):
    for m in _masks(4, seed=k * 10 + iters):
        want = JA.smooth_mask(m, k, iters)
        got = TA.smooth_mask(_t(m), k, iters).numpy()
        np.testing.assert_array_equal(got, want)


def test_fill_holes_bit_equal_jax():
    for m in _masks(12, seed=3) + _masks(4, hw=(40, 33), seed=4):
        np.testing.assert_array_equal(TA.fill_holes(_t(m)).numpy(),
                                      JA.fill_holes(m))


@pytest.mark.parametrize("radius", list(range(1, 18)))
def test_brush_bit_equal_jax(radius):
    img = np.zeros((40, 52, 3), np.uint8)
    pts = [(0, 0), (51, 39), (25, 20), (-3, 10), (54, 5), (10, 39)]
    for label in (1, 0):
        js = JA.AnnotationSession(img, None)
        ts = TA.AnnotationSession(img, None, device="cpu")
        js.state.mask[5:30, 5:45] = 255
        ts.state.mask[5:30, 5:45] = 255
        js.brush(pts, label, radius)
        ts.brush(pts, label, radius)
        np.testing.assert_array_equal(ts.state.mask, js.state.mask)


@pytest.mark.parametrize("src", [(32, 32), (37, 50), (100, 77), (64, 64)])
def test_proposal_resize_bit_equal_jax(src):
    img = np.zeros((64, 80, 3), np.uint8)
    prop = _masks(1, hw=src, seed=src[0])[0]
    js = JA.AnnotationSession(img, prop)
    ts = TA.AnnotationSession(img, prop, device="cpu")
    np.testing.assert_array_equal(ts.state.mask, js.state.mask)


def test_seg_friendly_equal_jax_and_needs_cv2(monkeypatch):
    """seg_friendly runs without OpenCV now and equals the JAX function's
    cv2 chain; run_ui's window still needs cv2's highgui."""
    img = np.random.default_rng(2).integers(0, 255, (48, 64, 3), np.uint8)
    want = JA.seg_friendly(img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(TA.seg_friendly(img), want)
    with pytest.raises(RuntimeError, match="highgui"):
        TA.run_ui([], Path("unused"), device="cpu")


# ------------------------------------------------------------ session

class FakeSam:
    """The JAX test's predictor stub, masks from the prompt alone; with
    the port's embed / set_embedding, and JAX's set_image /
    get_image_embedding, so either worker can drive it."""

    def __init__(self, hw=(64, 64)):
        self.hw = hw
        self.features = None

    def set_image(self, img):
        self.features = int(img[img.shape[0] // 2, img.shape[1] // 2, 0])

    def get_image_embedding(self):
        return self.features

    def embed(self, img):
        return int(img[img.shape[0] // 2, img.shape[1] // 2, 0])

    def set_embedding(self, e):
        self.features = e

    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output=False):
        H, W = self.hw
        m = np.zeros((H, W), bool)
        if box is not None:
            x0, y0, x1, y1 = box
            m[y0:y1, x0:x1] = True
        elif point_coords is not None:
            yy, xx = np.ogrid[:H, :W]
            for (x, y), lab in zip(point_coords, point_labels):
                m |= (yy - y) ** 2 + (xx - x) ** 2 <= (25 if lab else 9)
        return m[None], None, None


def _session_script(s):
    """The same edits on either package's session: masks after each."""
    out = []
    for op in (lambda: s.apply_box((5, 5, 20, 22)),
               lambda: s.apply_points([(40, 40), (44, 41)], [1, 1]),
               lambda: s.brush([(10, 50), (12, 52)], 1, 4),
               lambda: s.brush([(40, 40)], 0, 3),
               s.fill_holes,
               s.toggle_smoothing,
               lambda: s.apply_points([(20, 30)], [0]),
               lambda: s.apply_box((30, 2, 60, 12)),
               s.toggle_smoothing,
               lambda: s.apply_box((0, 50, 64, 64)),
               s.reset,
               lambda: s.apply_points([(3, 3)], [1])):
        op()
        out.append(s.state.mask.copy())
    out.append(s.overlay())
    return out


def test_session_bit_equal_jax_with_fake_sam():
    img = np.random.default_rng(5).integers(0, 255, (64, 64, 3), np.uint8)
    prop = _masks(1, hw=(32, 32), seed=9)[0]
    js = JA.AnnotationSession(img, prop, predictor=FakeSam())
    ts = TA.AnnotationSession(img, prop, predictor=FakeSam(), device="cpu")
    for a, b in zip(_session_script(ts), _session_script(js)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["size", "orig", "same"])
def test_save_decodes_equal_jax(tmp_path, how):
    img = np.zeros((64, 64, 3), np.uint8)
    js = JA.AnnotationSession(img, None)
    ts = TA.AnnotationSession(img, None, device="cpu")
    m = _masks(1, hw=(64, 64), seed=11)[0]
    js.state.mask[:] = m
    ts.state.mask[:] = m
    kw = {"size": dict(size=40), "orig": dict(orig_hw=(48, 40)),
          "same": dict(size=64)}[how]
    js.save(tmp_path / "j" / "m.png", **kw)
    ts.save(tmp_path / "t" / "m.png", **kw)
    want = cv2.imread(str(tmp_path / "j" / "m.png"), cv2.IMREAD_UNCHANGED)
    got = image_io.decode_png((tmp_path / "t" / "m.png").read_bytes())
    np.testing.assert_array_equal(got, want)


def test_save_without_cv2_writes_the_same_pixels(tmp_path, monkeypatch):
    ts = TA.AnnotationSession(np.zeros((64, 64, 3), np.uint8), None,
                              device="cpu")
    ts.state.mask[:] = _masks(1, hw=(64, 64), seed=12)[0]
    ts.save(tmp_path / "a.png", orig_hw=(50, 60))
    monkeypatch.setattr(image_io, "have_cv2", lambda: False)
    ts.save(tmp_path / "b.png", orig_hw=(50, 60))
    assert image_io.decode_png((tmp_path / "b.png").read_bytes()).tolist() \
        == cv2.imread(str(tmp_path / "a.png"), 0).tolist()


# ------------------------------------------------------------ proposer

@pytest.fixture(scope="module")
def effnet_pth(tmp_path_factory):
    model, jmodel, variables = port_effnet_and_jax_twin(seed=21)
    pth = tmp_path_factory.mktemp("prop") / "model.pth"
    torch.save(model.state_dict(), pth)
    return pth, jmodel, variables


def test_proposer_matches_tpu_proposer(effnet_pth, monkeypatch):
    """A 1280x720 frame at img_size 64 (the letterbox of 1536 is an
    integer multiple, so the native loader equals cv2's resize)."""
    pth, jmodel, variables = effnet_pth
    monkeypatch.setattr(JE, "load_member", lambda *a, **k: JE.EnsembleMember(
        jmodel, variables, 1.0, 0.5))
    jp = JA.TPUProposer(Path("unused"), img_size=64)
    tp = TA.Proposer(pth, img_size=64, device="cpu")
    rgb = frame(np.random.default_rng(7), (720, 1280))
    got = tp.probs(rgb).numpy()
    lb = JA.G.letterbox_side_pad(rgb, side_padding_ratio=0.1)
    x = cv2.resize(lb, (64, 64), interpolation=cv2.INTER_LINEAR)
    want = np.asarray(jp._fwd(jnp.asarray(x[None])))[0]
    np.testing.assert_allclose(got, want, atol=PROBS_TOL)
    thr = float(np.median(want))
    jp.threshold = tp.threshold = thr
    jm, tm = jp.propose(rgb), tp.propose(rgb)
    assert tm.dtype == np.uint8 and tm.shape == (64, 64)
    assert 0.05 < (jm > 0).mean() < 0.95
    far = np.abs(want - thr) > PROBS_TOL
    np.testing.assert_array_equal(tm[far], jm[far])


def test_proposer_refuses_a_directory(tmp_path):
    with pytest.raises(ValueError, match="convert.py"):
        TA.Proposer(tmp_path, device="cpu")


# ------------------------------------------------------------- prefetch

def _png_tree(root: Path, n: int, hw=(60, 80)) -> list:
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        img = np.full(hw + (3,), 20 + 40 * i, np.uint8)
        img[::7, ::5] = 200
        p = root / f"img_{i}.png"
        cv2.imwrite(str(p), img)
        paths.append(p)
    return paths


def test_prefetch_worker_items_equal_jax(tmp_path):
    """make_easy on, no proposer: the displayed image (letterbox of
    96 -> 48, an integer ratio) and orig_hw as JAX's worker gives them;
    an unreadable file is skipped by both."""
    paths = _png_tree(tmp_path, 3)
    (tmp_path / "bad.jpeg").write_text("not an image")
    paths.insert(1, tmp_path / "bad.jpeg")
    j = list(JA.PrefetchWorker(paths, None, img_size=48).start())
    t = list(TA.PrefetchWorker(paths, None, img_size=48,
                               device="cpu").start())
    assert [i.path for i in t] == [i.path for i in j] == \
        [paths[0]] + paths[2:]
    for a, b in zip(t, j):
        assert a.orig_hw == b.orig_hw == (60, 80)
        assert a.proposal is None and a.sam_features is None
        np.testing.assert_array_equal(a.image_rgb, b.image_rgb)
        assert set(a.timings) >= {"read", "letterbox", "propose", "embed"}


def test_prefetch_worker_raises_what_jax_swallows(tmp_path):
    """JAX drops an image whose proposer raises; the port's consumer gets
    the error."""
    paths = _png_tree(tmp_path, 2)

    class Broken:
        def propose(self, rgb):
            raise ValueError("proposer launch failed")

    assert list(JA.PrefetchWorker(paths, Broken(), img_size=48,
                                  make_easy=False).start()) == []
    w = TA.PrefetchWorker(paths, Broken(), img_size=48, make_easy=False,
                          device="cpu").start()
    with pytest.raises(RuntimeError) as e:
        list(w)
    assert isinstance(e.value.__cause__, ValueError)


def test_sam_embed_then_set_embedding_equals_set_image():
    """The port's predictor: embed leaves the state alone, and prompts
    after set_embedding(embed(img)) equal prompts after set_image(img)."""
    cfg = tsam.SamConfig(img_size=128, patch_size=16, encoder_dim=32,
                         encoder_depth=2, encoder_heads=2,
                         global_attn_indexes=(1,), window_size=4,
                         prompt_dim=32, mask_in_chans=16, decoder_heads=2,
                         decoder_mlp_dim=64, global_attn_flash=True)
    pred = tsam.SamPredictor(sam_official_state_dict(cfg), cfg,
                             device="cpu")
    r = np.random.default_rng(3)
    a, b = (r.integers(0, 255, (96, 128, 3), np.uint8) for _ in range(2))
    ea = pred.embed(a)
    assert pred.features is None
    pred.set_image(b)
    want_b = pred.predict(point_coords=[(30, 40)], point_labels=[1])[0]
    eb = pred.embed(b)
    assert torch.equal(eb.features, pred.features)
    pred.set_embedding(ea)
    got_a = pred.predict(point_coords=[(30, 40)], point_labels=[1])[0]
    pred.set_image(a)
    want_a = pred.predict(point_coords=[(30, 40)], point_labels=[1])[0]
    np.testing.assert_array_equal(got_a, want_a)
    pred.set_embedding(eb)
    np.testing.assert_array_equal(
        pred.predict(point_coords=[(30, 40)], point_labels=[1])[0], want_b)


# --------------------------------------------------- the reference's race

class GatedSam(FakeSam):
    """set_image / embed block until the test lets one through; the
    embedding is the image's centre value, and predict answers with it."""

    def __init__(self):
        super().__init__((48, 48))
        self.go = threading.Semaphore(0)
        self.done = threading.Semaphore(0)
        self.decoded = []

    def set_image(self, img):
        self.go.acquire()
        super().set_image(img)
        self.done.release()

    def embed(self, img):
        self.go.acquire()
        e = super().embed(img)
        self.done.release()
        return e

    def predict(self, **kw):
        self.decoded.append(self.features)
        return super().predict(**kw)


def _let_through(sam, n):
    for _ in range(n):
        sam.go.release()
        assert sam.done.acquire(timeout=30)


def test_reference_embedding_race_and_the_port_fix(tmp_path):
    """Four images; the worker embeds three (two queued, the third
    waiting for room), the UI takes item 0 and injects its features,
    then the worker embeds image 3. In JAX the click on image 0 decodes
    against image 3's embedding; the port's session decodes image 0's."""
    paths = _png_tree(tmp_path, 4)
    tags = [20 + 40 * i for i in range(4)]

    sam = GatedSam()
    worker = JA.PrefetchWorker(paths, None, sam, img_size=48,
                               make_easy=False).start()
    _let_through(sam, 3)
    items = iter(worker)
    item = next(items)
    sam.features = item.sam_features            # run_ui's injection (:391)
    assert item.sam_features == tags[0]
    _let_through(sam, 1)
    session = JA.AnnotationSession(item.image_rgb, None, sam)
    session.apply_points([(24, 24)], [1])
    assert sam.decoded == [tags[3]]             # another image's embedding
    list(items)

    sam = GatedSam()
    worker = TA.PrefetchWorker(paths, None, sam, img_size=48,
                               make_easy=False, device="cpu").start()
    _let_through(sam, 3)
    items = iter(worker)
    item = next(items)
    session = TA.AnnotationSession(item.image_rgb, None, sam,
                                   embedding=item.sam_features,
                                   device="cpu")
    _let_through(sam, 1)
    session.apply_points([(24, 24)], [1])
    session.apply_box((2, 2, 30, 30))
    assert sam.decoded == [tags[0], tags[0]]    # its own image, each time
    assert [i.sam_features for i in items] == tags[1:]


# --------------------------------------------------------------- run_ui

class ScriptedCv2(types.ModuleType):
    """The real cv2 with its window calls replaced: waitKey replays a
    script of mouse events (sent to the registered callback) and keys."""

    def __init__(self, script):
        super().__init__("cv2")
        self.__spec__ = cv2.__spec__
        self._script = list(script)
        self._cb = None
        self.shown = 0

    def __getattr__(self, name):
        return getattr(cv2, name)

    def namedWindow(self, *a, **k):
        pass

    def destroyAllWindows(self):
        pass

    def setMouseCallback(self, win, cb, *a):
        self._cb = cb

    def imshow(self, win, img):
        assert img.dtype == np.uint8 and img.ndim == 3
        self.shown += 1

    def waitKey(self, delay=0):
        step = self._script.pop(0)
        if isinstance(step, str):
            return ord(step)
        for event, x, y, flags in step:
            self._cb(event, x, y, flags, None)
        return -1


def _drag(pts, flags=0):
    (x0, y0), rest = pts[0], pts[1:]
    return ([(cv2.EVENT_LBUTTONDOWN, x0, y0, flags)]
            + [(cv2.EVENT_MOUSEMOVE, x, y, flags) for x, y in rest]
            + [(cv2.EVENT_LBUTTONUP, *pts[-1], flags)])


CTRL, SHIFT = cv2.EVENT_FLAG_CTRLKEY, cv2.EVENT_FLAG_SHIFTKEY
UI_SCRIPT = [
    # image 0: a stroke, fill, smoothing off, a box, a negative stroke, save
    _drag([(10, 12), (14, 16), (20, 18)]), "f", "m",
    _drag([(4, 30), (30, 44)], CTRL), _drag([(12, 14), (13, 15)], SHIFT),
    "s",
    "x",                                  # image 1: skip
    # image 2: a stroke, reset, another stroke, save
    _drag([(30, 30), (36, 30)]), "r", _drag([(8, 40), (9, 41)]), "s",
    "q",                                  # image 3: quit
]


class ContentProposer:
    """A proposer whose mask depends on the image alone."""

    def __init__(self, size):
        self.size = size

    def propose(self, rgb):
        m = ((rgb[..., 0] > 100) * 255).astype(np.uint8)
        return cv2.resize(m, (self.size, self.size),
                          interpolation=cv2.INTER_NEAREST)


def _run_ui(module, out, paths, monkeypatch, sam, scale, **kw):
    proxy = ScriptedCv2(UI_SCRIPT)
    monkeypatch.setitem(sys.modules, "cv2", proxy)
    if sam:
        monkeypatch.setattr(module, "load_sam",
                            lambda *a, **k: FakeSam((48, 48)))
    module.run_ui(paths, out, ContentProposer(48),
                  Path("sam.pth") if sam else None, img_size=48,
                  display_scale=scale, **kw)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    assert not proxy._script and proxy.shown > 0
    return {p.relative_to(out).as_posix(): (
        cv2.imread(str(p), cv2.IMREAD_UNCHANGED) if p.suffix == ".png"
        else p.read_bytes()) for p in sorted(out.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("sam,mode,scale", [
    (False, "fixed", 1.0), (True, "fixed", 1.0), (False, "orig", 2.0),
    (True, "orig", 1.0)])
def test_run_ui_saves_what_jax_saves(tmp_path, monkeypatch, sam, mode,
                                     scale):
    """JAX's and the port's run_ui through the same scripted proxy cv2:
    the same files, the masks equal after decoding."""
    paths = _png_tree(tmp_path / "imgs", 4)
    kw = (dict(save_size=32) if mode == "fixed"
          else dict(save_size=None, save_original_res=True))
    want = _run_ui(JA, tmp_path / "j", paths, monkeypatch, sam, scale, **kw)
    got = _run_ui(TA, tmp_path / "t", paths, monkeypatch, sam, scale,
                  device="cpu", **kw)
    assert sorted(got) == sorted(want) == [
        "_skipped/img_1.skip", "img_0.png", "img_2.png"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["img_0.png"].any()


# ------------------------------------------------------------ selection

def test_selection_helpers_equal_jax(tmp_path):
    csvp = tmp_path / "hard_candidates.csv"
    csvp.write_text("path,composite\n/a/x.jpeg,0.9\n/a/y.jpeg,0.8\n")
    for limit in (None, 1):
        assert TA.load_hard_candidates(csvp, limit) == \
            JA.load_hard_candidates(csvp, limit)
    imgs = [tmp_path / f"img_{i}.jpeg" for i in range(4)]
    out = tmp_path / "out"
    (out / "sub").mkdir(parents=True)
    cv2.imwrite(str(out / "sub" / "img_0.png"), np.zeros((4, 4), np.uint8))
    TA.write_skip_marker(tmp_path / "skips", imgs[1])
    assert (tmp_path / "skips" / "img_1.skip").exists()
    assert TA.pending_paths(imgs, [out], tmp_path / "skips") == \
        JA.pending_paths(imgs, [out], tmp_path / "skips") == imgs[2:]
    assert TA.IMG_EXTS == JA.IMG_EXTS


# ------------------------------------------------------------ workloads

def _record(monkeypatch, module, proposer_name):
    calls = {}

    class FakeProposer:
        def __init__(self, *a, **k):
            k.pop("device", None)
            calls["proposer"] = (a, k)

    def fake_run_ui(paths, out_dir, proposer, sam, **k):
        k.pop("device", None)
        calls["run_ui"] = (list(paths), out_dir,
                           type(proposer).__name__, sam, k)

    monkeypatch.setattr(module, proposer_name, FakeProposer)
    monkeypatch.setattr(module, "run_ui", fake_run_ui)
    return calls


@pytest.mark.parametrize("name", ["create_testset", "create_hard_masks",
                                  "create_more_specific_data"])
def test_workload_mains_pass_jax_arguments(tmp_path, monkeypatch, name):
    jmod, tmod = {"create_testset": (j_test, t_test),
                  "create_hard_masks": (j_hard, t_hard),
                  "create_more_specific_data": (j_more, t_more)}[name]
    imgs = _png_tree(tmp_path / "imgs", 3)
    (tmp_path / "imgs" / "notes.txt").write_text("skip me")
    out, also = tmp_path / "out", tmp_path / "also"
    out.mkdir()
    also.mkdir()
    cv2.imwrite(str(also / "img_0.png"), np.zeros((4, 4), np.uint8))
    cands = tmp_path / "hard.csv"
    with open(cands, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "composite"])
        w.writerows([[str(p), 1.0] for p in imgs[::-1]])
    argv = {"create_testset": ["--images_root", str(tmp_path / "imgs"),
                               "--sam_checkpoint", "sam.pth"],
            "create_hard_masks": ["--candidates", str(cands), "--limit",
                                  "2", "--img_size", "256"],
            "create_more_specific_data": [
                "--images_root", str(tmp_path / "imgs"), "--also_done",
                str(also)]}[name]
    argv += ["--out_dir", str(out), "--checkpoint", "m.pth"]
    jc = _record(monkeypatch, jmod, "TPUProposer")
    tc = _record(monkeypatch, tmod, "Proposer")
    jmod.main(argv)
    # the port's main takes the fp32 policy for its process (the flags
    # are given back when the test ends)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tmod.main(argv + ["--device", "cpu"])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert tc == jc
    assert jc["run_ui"][0]              # some paths were handed over
