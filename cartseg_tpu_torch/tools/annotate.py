"""Interactive SAM-assisted annotation (counterpart of
cartseg_tpu/tools/annotate.py): the reference's HITL tools
(src/create_testset.py, src/data_preprocessing/create_hard_masks.py,
create_more_specific_data.py) on the card.

  * proposal masks come from a `.pth` checkpoint through the port's
    ensemble forward (`Proposer`, the counterpart of `TPUProposer`);
  * SAM ViT-B point/box prompting runs the port's predictor
    (models/sam.py; its global blocks launch the flash-attention kernel
    on the card);
  * a prefetch thread reads, letterboxes, proposes and embeds the next
    images while the user edits the current one (`PrefetchWorker`);
  * the editing state machine (`AnnotationSession`): smoothing (cv2's
    close, open, Gaussian blur and threshold, bit for bit without
    OpenCV: ops/morphology.py and ops/filters.py), hole filling (the CC
    kernel on the card), the brush, saving, skip markers and
    skip-existing resume;
  * the `seg_friendly` preprocessing on the worker's device (the
    bilateral kernel on the card, 8-bit Lab and CLAHE in torch).

Only `run_ui`'s window needs OpenCV (highgui and a display) and imports
it where it runs, raising with its reason without it; the session, the
worker, the preprocessing and the saving run on a machine without cv2.

Deviations from the JAX module, by design:
  * the prefetch thread embeds each image with `SamPredictor.embed`,
    which leaves the predictor alone, and the session installs its own
    image's embedding before each prompt, in the thread that prompts.
    JAX's `run_ui` injects `sam.features` once per item
    while its worker goes on calling `set_image` on the same predictor,
    so a later click can decode against another image's embedding;
  * the worker skips only an unreadable image (what cv2.imread gives
    None for); any other exception reaches the consumer, where JAX's
    `except Exception` drops the image silently.

Keys (reference bindings): s=save, r=reset, m=toggle smoothing,
f=fill holes, x=skip (writes a .skip marker), q/ESC=quit.
Mouse: drag=FG points, Shift+drag=BG points, Ctrl+drag=box.
"""

from __future__ import annotations

import csv
import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cartseg_tpu_torch import geometry as G
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.models.sam import SamConfig, load_sam_checkpoint
from cartseg_tpu_torch.ops.clahe import clahe_u8
from cartseg_tpu_torch.ops.color import (add_weighted, bgr_to_lab_u8,
                                         convert_scale_abs, lab_to_bgr_u8)
from cartseg_tpu_torch.ops.filters import bilateral_u8, gaussian_blur_u8
from cartseg_tpu_torch.ops.morphology import (dilate, erode,
                                              fill_holes_from_border)

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs OpenCV (cv2), which is not installed") from e
    return cv2


# ------------------------------------------------------------ preproc

def _blur_hwc(img: torch.Tensor, sigma: float) -> torch.Tensor:
    return gaussian_blur_u8(img.permute(2, 0, 1), sigma).permute(1, 2, 0)


def seg_friendly(img_bgr: np.ndarray, device="cpu") -> np.ndarray:
    """Edge-preserving smooth + contrast boost + CLAHE + sharpen
    (create_hard_masks.py:117-138) of an HxWx3 uint8 BGR image, on
    `device`, without OpenCV: the JAX function's cv2 chain, stage by
    stage, bilateral filter (ops/filters.py; the CUDA kernel on a card),
    Gaussian blur, convertScaleAbs, 8-bit BGR -> Lab (ops/color.py),
    CLAHE on L (ops/clahe.py), Lab -> BGR, Gaussian blur and
    addWeighted. Every stage but the bilateral filter is bit-equal to
    its cv2 call; that one rounds 0-2 values of a 1280x720 frame 1 off
    cv2's (ops/filters.py)."""
    x = torch.from_numpy(np.ascontiguousarray(img_bgr, np.uint8)).to(
        resolve_device(device))
    x = _blur_hwc(bilateral_u8(x, 15, 100.0, 15.0), 1.5)
    lab = bgr_to_lab_u8(convert_scale_abs(x, 1.3))
    lab = torch.stack([clahe_u8(lab[..., 0], 4.0, (4, 4)), lab[..., 1],
                       lab[..., 2]], -1)
    bgr = lab_to_bgr_u8(lab)
    out = add_weighted(bgr, 1.5, _blur_hwc(bgr, 1.0), -0.5, 0.0)
    return out.cpu().numpy()


def smooth_mask(mask: torch.Tensor, k: int = 5, iters: int = 1,
                blur_sigma: Optional[float] = None) -> torch.Tensor:
    """close -> open -> Gaussian -> threshold (create_testset.py:150-159)
    of a uint8 {0,255} [H,W] mask, on its device: cv2.morphologyEx with
    the k x k ellipse (dilate `iters` times then erode `iters` times for
    the close, the reverse for the open), cv2.GaussianBlur at
    blur_sigma (k / 2 by default) and `> 127`, bit for bit."""
    k = max(3, int(k) | 1)
    m = mask > 127
    for op in (dilate,) * iters + (erode,) * (2 * iters) + (dilate,) * iters:
        m = op(m, k)
    if blur_sigma is None:
        blur_sigma = k / 2.0
    blurred = gaussian_blur_u8(m.to(torch.uint8) * 255, blur_sigma)
    return (blurred > 127).to(torch.uint8) * 255


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill inner contours (create_testset.py hole filler): background
    that no 4-connected background path links to the border becomes
    foreground, which is what cv2's RETR_CCOMP contours filled with
    drawContours give. uint8 [H,W] -> uint8 {0,255}, on its device (the
    CC kernel on the card)."""
    return fill_holes_from_border(mask > 127).to(torch.uint8) * 255


def disk_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """(dy, dx) of the filled disk cv2.circle paints: x^2 + y^2 <= r^2."""
    r = int(radius)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    inside = dy * dy + dx * dx <= r * r
    return dy[inside], dx[inside]


def paint_disks(mask: torch.Tensor, points: Sequence[Tuple[int, int]],
                value: int, radius: int) -> torch.Tensor:
    """Paint filled disks of `radius` at (x, y) points into a uint8
    [H,W] mask on its device, clipped at the edges, in one scatter."""
    H, W = mask.shape
    dy, dx = disk_offsets(radius)
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    ys = (pts[:, 1:2] + dy[None]).ravel()
    xs = (pts[:, 0:1] + dx[None]).ravel()
    keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    flat = torch.from_numpy(ys[keep] * W + xs[keep]).to(mask.device)
    out = mask.reshape(-1).clone()
    out[flat] = value
    return out.reshape(H, W)


# ----------------------------------------------------- proposals on the card

class Proposer:
    """Initial-mask proposals from a `.pth` checkpoint (counterpart of
    `TPUProposer`, annotate.py:91-123; the annotation tools' UNet
    inference, create_testset.py:173-181): infer/engine.py `load_member`
    (a directory raises, as there: the port takes no Orbax checkpoint)
    and `ensemble_probs_fn`, bf16 on the card, float32 on the CPU."""

    def __init__(self, checkpoint: Path, encoder: str = "efficientnet-b0",
                 img_size: int = 512, imagenet_norm: bool = True,
                 side_padding_ratio: float = 0.1, *, device="cuda"):
        from cartseg_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
        from cartseg_tpu_torch.infer.engine import (ensemble_probs_fn,
                                                    load_member)

        self.device = resolve_device(device)
        member = load_member(Path(checkpoint), encoder, device=self.device)
        mean = IMAGENET_MEAN if imagenet_norm else (0, 0, 0)
        std = IMAGENET_STD if imagenet_norm else (1, 1, 1)
        self._fwd = ensemble_probs_fn([member], mean, std)
        self.threshold = member.threshold
        self.img_size = img_size
        self.side_padding_ratio = side_padding_ratio

    def probs(self, rgb: np.ndarray) -> torch.Tensor:
        """RGB HxWx3 uint8 -> [img_size, img_size] fp32 probabilities in
        letterboxed space, on the device. The letterbox and resize are
        the native loader's (geometry.letterbox_resize)."""
        x = G.letterbox_resize(rgb, self.img_size, self.side_padding_ratio)
        return self._fwd(torch.from_numpy(x).to(self.device)[None])[0]

    def propose(self, rgb: np.ndarray) -> np.ndarray:
        """RGB HxWx3 -> uint8 {0,255} proposal at img_size^2 in
        letterboxed space."""
        m = (self.probs(rgb) >= self.threshold).to(torch.uint8) * 255
        return m.cpu().numpy()


# -------------------------------------------------------------------- SAM

def load_sam(checkpoint: Optional[Path] = None, model_type: str = "vit_b",
             *, device="cuda", cfg: Optional[SamConfig] = None):
    """A predictor with the SamPredictor interface, or None without a
    checkpoint or for a model type other than vit_b (as the JAX
    package's TPU backend). Runs on `device`: the card by default, the
    CPU only when asked. The JAX module's host `segment_anything`
    backend is not ported: the port's own predictor is the backend."""
    if checkpoint is None or model_type != "vit_b":
        return None
    return load_sam_checkpoint(checkpoint, cfg, device=device)


# ------------------------------------------------------------- session

@dataclasses.dataclass
class SessionState:
    mask: np.ndarray          # uint8 {0,255}, working canvas (host)
    apply_smoothing: bool = True
    smooth_k: int = 5
    smooth_iters: int = 1


class AnnotationSession:
    """The editing state machine behind the UI, headless-testable.

    Prompt results merge with OR (create_testset.py box/point merges);
    brush strokes paint directly; post ops are smoothing + hole fill.
    The canvas stays on the host, as in JAX, and each operation runs on
    `device`. Built with an item's `embedding` (models/sam.py
    `SamEmbedding`), the session installs it on the predictor before
    each prompt, so every prompt decodes against its own image: the
    prefetch worker's `embed` leaves the predictor's state alone.
    """

    def __init__(self, image_rgb: np.ndarray, proposal: Optional[np.ndarray],
                 predictor=None, *, embedding=None, device="cuda"):
        self.device = resolve_device(device)
        self.image = image_rgb
        h, w = image_rgb.shape[:2]
        if proposal is not None and proposal.shape != (h, w):
            proposal = G.resize_nearest(proposal, (h, w))
        self.state = SessionState(
            mask=(proposal.copy() if proposal is not None
                  else np.zeros((h, w), np.uint8)))
        self.predictor = predictor  # SamPredictor-like or None
        self.embedding = embedding

    def _on_device(self, fn, *args) -> np.ndarray:
        m = torch.from_numpy(self.state.mask).to(self.device)
        return fn(m, *args).cpu().numpy()

    # --- post ops
    def _post(self, m: np.ndarray) -> np.ndarray:
        if self.state.apply_smoothing:
            t = smooth_mask(torch.from_numpy(m).to(self.device),
                            self.state.smooth_k, self.state.smooth_iters)
            m = t.cpu().numpy()
        return m

    # --- prompt ops (need a predictor)
    def _predict(self, **prompt) -> np.ndarray:
        if self.embedding is not None:
            self.predictor.set_embedding(self.embedding)
        masks, _, _ = self.predictor.predict(multimask_output=False,
                                             **prompt)
        return (masks[0] * 255).astype(np.uint8)

    def apply_points(self, points: Sequence[Tuple[int, int]],
                     labels: Sequence[int]):
        if self.predictor is None or not points:
            return
        new = self._predict(point_coords=np.asarray(points),
                            point_labels=np.asarray(labels))
        self.state.mask = self._post(np.bitwise_or(self.state.mask, new))

    def apply_box(self, box: Tuple[int, int, int, int]):
        if self.predictor is None:
            return
        new = self._predict(box=np.asarray(box))
        self.state.mask = self._post(np.bitwise_or(self.state.mask, new))

    # --- direct ops (no predictor needed)
    def brush(self, points: Sequence[Tuple[int, int]], label: int,
              radius: int = 6):
        if len(points) == 0:
            return
        pts = [(int(x), int(y)) for x, y in points]
        self.state.mask = self._on_device(paint_disks, pts,
                                          255 if label else 0, radius)

    def fill_holes(self):
        self.state.mask = self._on_device(fill_holes)

    def reset(self):
        self.state.mask[:] = 0

    def toggle_smoothing(self):
        self.state.apply_smoothing = not self.state.apply_smoothing

    def overlay(self) -> np.ndarray:
        """Render the current mask tinted over the image."""
        out = self.image.astype(np.float32).copy()
        sel = self.state.mask > 127
        out[sel] = out[sel] * 0.55 + np.array([255, 0, 0]) * 0.45
        return out.astype(np.uint8)

    def save(self, path: Path, size: Optional[int] = None,
             orig_hw: Optional[Tuple[int, int]] = None,
             side_padding_ratio: float = 0.1):
        """Save at a fixed square size (512 for create_hard_masks, 224
        for create_more_specific_data) or, with orig_hw, un-letterboxed
        at original resolution (create_testset.py:391-396), with cv2
        INTER_NEAREST's index rule, as a PNG (utils/image_io.write_png:
        cv2 where installed, else the port's codec)."""
        from cartseg_tpu_torch.utils.image_io import write_png

        m = self.state.mask
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if orig_hw is not None:
            oh, ow = orig_hw
            m = G.remove_letterbox(m, ow, oh, side_padding_ratio)
        elif size is not None and m.shape != (size, size):
            m = G.resize_nearest(m, (size, size))
        write_png(path, m)


# ------------------------------------------------------------- prefetch

@dataclasses.dataclass
class PrefetchItem:
    path: Path
    image_rgb: np.ndarray      # preprocessed (seg_friendly+letterbox+resize)
    proposal: Optional[np.ndarray]
    orig_hw: Tuple[int, int]
    sam_features: object = None   # models/sam.py SamEmbedding, or None
    # host seconds of each stage: read, seg_friendly, letterbox,
    # propose, embed
    timings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Failed:
    error: BaseException


def _unreadable_jpeg(path: Path) -> bool:
    """A .jpg/.jpeg whose bytes do not start a JPEG: cv2.imread gives None
    for it, and nvJPEG would raise."""
    with open(path, "rb") as f:
        return f.read(3) != b"\xff\xd8\xff"


class PrefetchWorker:
    """Compute-ahead thread: read, preprocess, propose and embed the next
    images while the user edits the current one (create_testset.py:
    163-198; queue bounded at 2).

    Streams: the thread launches the proposer's forward and the SAM
    encoder on the device's current stream (the default stream, the one
    the UI thread's session launches on, so the items need no
    cross-stream synchronisation), and nvJPEG decodes on the thread's own
    decode stream (utils/jpeg.py), synchronised before the read returns.
    The thread waits for each embedding before it queues the item, so
    the consumer's wait for an item shows whether the prefetch keeps up.

    Only an unreadable image (a missing file, bytes cv2.imread cannot
    read) is skipped; any other exception ends the thread and is raised
    again in the consumer's iteration."""

    def __init__(self, paths: Sequence[Path], proposer: Optional[Proposer],
                 sam_predictor=None, img_size: int = 512,
                 make_easy: bool = True,
                 side_padding_ratio: float = 0.1, *, device="cuda"):
        self.paths = list(paths)
        self.proposer = proposer
        self.sam = sam_predictor
        self.img_size = img_size
        self.make_easy = make_easy
        self.side_padding_ratio = side_padding_ratio
        self.device = resolve_device(device)
        self.queue: "queue.Queue" = queue.Queue(maxsize=2)
        self.stop_event = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.stop_event.set()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout)

    def _read(self, path: Path) -> Optional[np.ndarray]:
        from cartseg_tpu_torch.utils.image_io import read_rgb

        if not path.is_file():
            return None
        if self.device.type == "cuda" and \
                path.suffix.lower() in (".jpg", ".jpeg") and \
                _unreadable_jpeg(path):
            return None
        return read_rgb(path, self.device)

    def _prep(self, path: Path) -> Optional[PrefetchItem]:
        t = {}
        t0 = time.perf_counter()
        rgb = self._read(path)
        if rgb is None:
            return None
        orig_hw = rgb.shape[:2]
        t1 = time.perf_counter()
        t["read"] = t1 - t0
        if self.make_easy:
            rgb = np.ascontiguousarray(
                seg_friendly(rgb[..., ::-1], self.device)[..., ::-1])
            t["seg_friendly"] = time.perf_counter() - t1
            t1 = time.perf_counter()
        disp = G.letterbox_resize(rgb, self.img_size, self.side_padding_ratio)
        t2 = time.perf_counter()
        t["letterbox"] = t2 - t1
        proposal = self.proposer.propose(rgb) if self.proposer else None
        t3 = time.perf_counter()
        t["propose"] = t3 - t2
        emb = None
        if self.sam is not None:
            emb = self.sam.embed(disp)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        t["embed"] = time.perf_counter() - t3
        return PrefetchItem(path, disp, proposal, orig_hw, emb, t)

    def _put(self, item) -> bool:
        while not self.stop_event.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for p in self.paths:
                if self.stop_event.is_set():
                    break
                item = self._prep(Path(p))
                if item is not None and not self._put(item):
                    return
        except BaseException as e:    # raised again in __iter__
            self._put(_Failed(e))
            return
        self._put(None)

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is None:
                break
            if isinstance(item, _Failed):
                raise RuntimeError(
                    "the prefetch worker failed") from item.error
            yield item


# ---------------------------------------------------------- selection

def load_hard_candidates(csv_path: Path, limit: Optional[int] = None
                         ) -> List[Path]:
    """Top-ranked image paths from mine_hard_cases output
    (create_hard_masks.py:54-71)."""
    out = []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            out.append(Path(row["path"]))
            if limit and len(out) >= limit:
                break
    return out


def pending_paths(paths: Sequence[Path], out_dirs: Sequence[Path],
                  skip_dir: Optional[Path] = None) -> List[Path]:
    """Drop images already masked in any out dir or marked skipped
    (create_more_specific_data.py:161-172; .skip markers
    create_hard_masks.py:445-451)."""
    done = set()
    for d in out_dirs:
        d = Path(d)
        if d.exists():
            done |= {p.stem for p in d.rglob("*.png")}
    if skip_dir and Path(skip_dir).exists():
        done |= {p.stem for p in Path(skip_dir).glob("*.skip")}
    return [p for p in paths if p.stem not in done]


def write_skip_marker(skip_dir: Path, image_path: Path):
    skip_dir = Path(skip_dir)
    skip_dir.mkdir(parents=True, exist_ok=True)
    (skip_dir / f"{Path(image_path).stem}.skip").touch()


# ------------------------------------------------------------------ UI

def run_ui(paths: Sequence[Path], out_dir: Path,
           proposer: Optional[Proposer] = None,
           sam_checkpoint: Optional[Path] = None,
           img_size: int = 512, save_size: Optional[int] = 512,
           save_original_res: bool = False,
           make_easy: bool = True, display_scale: float = 1.0, *,
           device="cuda"):
    """The interactive OpenCV loop (requires a display and cv2's
    highgui): the JAX loop's keys and mouse bindings over
    AnnotationSession + PrefetchWorker, which run on `device`."""
    cv2 = _cv2("run_ui's window (highgui and a display)")

    out_dir = Path(out_dir)
    skip_dir = out_dir / "_skipped"
    sam = load_sam(sam_checkpoint, device=device) if sam_checkpoint \
        else None
    todo = pending_paths(paths, [out_dir], skip_dir)
    worker = PrefetchWorker(todo, proposer, sam, img_size, make_easy,
                            device=device).start()

    ui = {"drawing": False, "box_active": False, "box_start": None,
          "box_end": None, "clicks": [], "label": 1}

    for item in worker:
        session = AnnotationSession(item.image_rgb, item.proposal, sam,
                                    embedding=item.sam_features,
                                    device=device)

        def on_mouse(event, x, y, flags, _p):
            x = int(x / display_scale)
            y = int(y / display_scale)
            ctrl = bool(flags & cv2.EVENT_FLAG_CTRLKEY)
            shift = bool(flags & cv2.EVENT_FLAG_SHIFTKEY)
            if event == cv2.EVENT_LBUTTONDOWN:
                if ctrl:
                    ui.update(box_active=True, box_start=(x, y),
                              box_end=(x, y))
                else:
                    ui.update(drawing=True, label=0 if shift else 1,
                              clicks=[(x, y)])
            elif event == cv2.EVENT_MOUSEMOVE:
                if ui["box_active"]:
                    ui["box_end"] = (x, y)
                elif ui["drawing"]:
                    ui["clicks"].append((x, y))
            elif event == cv2.EVENT_LBUTTONUP:
                if ui["box_active"]:
                    ui["box_active"] = False
                    x1, y1 = ui["box_start"]
                    x2, y2 = ui["box_end"]
                    session.apply_box((min(x1, x2), min(y1, y2),
                                       max(x1, x2), max(y1, y2)))
                elif ui["drawing"]:
                    ui["drawing"] = False
                    pts = ui["clicks"]
                    if sam is not None:
                        session.apply_points(pts, [ui["label"]] * len(pts))
                    else:
                        session.brush(pts, ui["label"])

        win = "cartseg annotate"
        cv2.namedWindow(win)
        cv2.setMouseCallback(win, on_mouse)
        while True:
            disp = session.overlay()
            if display_scale != 1.0:
                disp = cv2.resize(disp, None, fx=display_scale,
                                  fy=display_scale)
            cv2.imshow(win, np.ascontiguousarray(disp[..., ::-1]))
            key = cv2.waitKey(30) & 0xFF
            if key == ord("s"):
                session.save(
                    out_dir / f"{item.path.stem}.png",
                    size=save_size,
                    orig_hw=item.orig_hw if save_original_res else None)
                break
            if key == ord("r"):
                session.reset()
            if key == ord("m"):
                session.toggle_smoothing()
            if key == ord("f"):
                session.fill_holes()
            if key == ord("x"):
                write_skip_marker(skip_dir, item.path)
                break
            if key in (ord("q"), 27):
                worker.stop()
                cv2.destroyAllWindows()
                return
        cv2.destroyAllWindows()
