"""On-device augmentation (counterpart of cartseg_tpu/data/augment.py):
albumentations' train_bce_dice.py:164-181 pipeline (and the 224
variant, finetune_for_224.py:88-109) as batched PyTorch ops on the
training device, drawn from an explicit `torch.Generator`.

The ops and their parameter distributions are the JAX package's:
per-sample flip, brightness/contrast, HSV, colour jitter, noise and
motion-blur gates; ONE affine warp (rotate, zoom, shift-scale-rotate
composed) whose parameters are shared across the batch, computed with
the JAX gather math (bilinear taps from uint8, reflect-101 border,
nearest for masks), not `grid_sample`. The random streams differ from
JAX's: the tests hold each op at fixed drawn parameters and the
marginals by KS tests. The JAX `per_sample_warp` option has no caller
on this slice and raises.

Layout: NHWC in and out ([B,H,W,3] images, [B,H,W,1] masks), as the
JAX package; the engine hands the model an NCHW view.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # geometric
    hflip_p: float = 0.5
    rotate_p: float = 0.5
    rotate_limit: float = 20.0
    scale_p: float = 0.5
    scale_limit: float = 0.12
    scale_mode: str = "zoom"  # "zoom" | "noop"
    shift_scale_rotate_p: float = 0.0  # the 224 finetune transform
    ssr_shift_limit: float = 0.02
    ssr_scale_limit: float = 0.12
    ssr_rotate_limit: float = 5.0
    # photometric
    brightness_contrast_p: float = 0.3
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2
    hsv_p: float = 0.2
    hue_shift: float = 20.0
    sat_shift: float = 30.0
    val_shift: float = 20.0
    color_jitter_p: float = 0.0
    cj_brightness: float = 0.08
    cj_contrast: float = 0.08
    cj_saturation: float = 0.05
    cj_hue: float = 0.02
    noise_p: float = 0.15
    noise_var: Tuple[float, float] = (10.0, 50.0)
    motion_blur_p: float = 0.15
    per_sample_warp: bool = False
    # normalization
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @staticmethod
    def train_512(imagenet_norm: bool = False) -> "AugmentConfig":
        """The train_bce_dice.py:164-175 pipeline."""
        return AugmentConfig(
            mean=IMAGENET_MEAN if imagenet_norm else (0, 0, 0),
            std=IMAGENET_STD if imagenet_norm else (1, 1, 1))

    @staticmethod
    def train_224(imagenet_norm: bool = True) -> "AugmentConfig":
        """The finetune_for_224.py:88-109 pipeline."""
        return AugmentConfig(
            hflip_p=0.5, rotate_p=0.0, scale_p=0.0,
            brightness_contrast_p=0.0, hsv_p=0.0, noise_p=0.0,
            motion_blur_p=0.0,
            shift_scale_rotate_p=0.20, color_jitter_p=0.15,
            mean=IMAGENET_MEAN if imagenet_norm else (0, 0, 0),
            std=IMAGENET_STD if imagenet_norm else (1, 1, 1))

    @staticmethod
    def none(imagenet_norm: bool = False) -> "AugmentConfig":
        """Val transform: normalize only."""
        return AugmentConfig(
            hflip_p=0, rotate_p=0, scale_p=0, brightness_contrast_p=0,
            hsv_p=0, noise_p=0, motion_blur_p=0, shift_scale_rotate_p=0,
            color_jitter_p=0,
            mean=IMAGENET_MEAN if imagenet_norm else (0, 0, 0),
            std=IMAGENET_STD if imagenet_norm else (1, 1, 1))

    @property
    def any_warp(self) -> bool:
        return (self.rotate_p > 0
                or (self.scale_p > 0 and self.scale_mode == "zoom")
                or self.shift_scale_rotate_p > 0)


# ------------------------------------------------------------- warping

def _reflect101(coord: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 index folding."""
    period = 2.0 * (n - 1)
    c = torch.remainder(coord.abs(), period)
    return torch.where(c > n - 1, period - c, c)


def _shared_affine_warp(images, masks, angle_deg, scale, ty, tx):
    """One affine resample shared across the batch (augment.py:137-187).

    images [B,H,W,C] uint8 or float (bilinear), masks [B,H,W,1]
    (nearest); angle/scale/ty/tx 0-dim float32 tensors. Batch*channel
    moves to the minor axis, so each bilinear tap is one shared-index
    row gather, in the input dtype; only the 4 taps are lifted to
    float32 for the lerp. Reflect-101 border. Returns float32 images.
    """
    B, H, W, C = images.shape
    dev = images.device
    th = -angle_deg * math.pi / 180.0
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    c, s = torch.cos(th), torch.sin(th)
    inv_s = 1.0 / scale
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(
        H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(
        H, W)
    # output (y,x) -> input coords (inverse transform about center+shift)
    dy, dx = yy - (cy + ty), xx - (cx + tx)
    sy = _reflect101((c * dy - s * dx) * inv_s + cy, H)
    sx = _reflect101((s * dy + c * dx) * inv_s + cx, W)

    y0 = torch.floor(sy).to(torch.int64)
    x0 = torch.floor(sx).to(torch.int64)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y0 = y0.clamp(0, H - 1)
    x0 = x0.clamp(0, W - 1)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]

    flat_img = images.permute(1, 2, 0, 3).reshape(H * W, B * C)

    def gi(yi, xi):
        taps = flat_img.index_select(0, (yi * W + xi).reshape(-1))
        return taps.reshape(H, W, B * C).to(torch.float32)

    out = (gi(y0, x0) * (1 - wy) * (1 - wx) + gi(y0, x1) * (1 - wy) * wx
           + gi(y1, x0) * wy * (1 - wx) + gi(y1, x1) * wy * wx)
    out_img = out.reshape(H, W, B, C).permute(2, 0, 1, 3)

    # nearest for masks
    yn = torch.round(sy).to(torch.int64).clamp(0, H - 1)
    xn = torch.round(sx).to(torch.int64).clamp(0, W - 1)
    flat_m = masks.permute(1, 2, 0, 3).reshape(H * W, B)
    out_m = flat_m.index_select(0, (yn * W + xn).reshape(-1)).reshape(
        H, W, B)
    return out_img.contiguous(), out_m.permute(2, 0, 1)[..., None]


# ----------------------------------------------------------- color ops

def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d == 0, 1.0, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    sat = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return h, sat, mx


def _hsv_to_rgb(h, s, v):
    """Sector-free formula: per channel n in {5,3,1},
    c = v - v*s*clip(min(k, 4-k), 0, 1) with k = (n + 6h) mod 6."""
    h6 = torch.remainder(h, 1.0) * 6.0
    vs = v * s

    def chan(n):
        kk = torch.remainder(n + h6, 6.0)
        return v - vs * torch.clamp(torch.minimum(kk, 4.0 - kk), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


@functools.lru_cache(maxsize=16)
def _channel_constants(mean, std, device):
    """Per-channel constants on `device`, made once: a fresh
    torch.tensor(..., device='cuda') is a blocking copy every step."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_batch(img, mean, std):
    """(x/255 - mean)/std on 0..255 floats (albumentations Normalize)."""
    m, s = _channel_constants(tuple(float(v) for v in mean),
                              tuple(float(v) for v in std), img.device)
    return (img / 255.0 - m) / s


def _rng(u, lo, hi):
    """Map a U[0,1) draw onto U[lo,hi)."""
    return lo + (hi - lo) * u


def draw_warp_params(u: torch.Tensor, cfg: AugmentConfig, H: int, W: int):
    """The composed affine parameters (angle deg, scale, ty, tx) from nine
    U[0,1) draws `u` [9, ...] (augment.py:235-271): Rotate(p, limit)
    U-mixture, zoom 1+U(-s,s) w.p. p, the ShiftScaleRotate triple."""
    shape = u.shape[1:]
    angle = torch.zeros(shape, dtype=torch.float32, device=u.device)
    scale = torch.ones(shape, dtype=torch.float32, device=u.device)
    ty = torch.zeros(shape, dtype=torch.float32, device=u.device)
    tx = torch.zeros(shape, dtype=torch.float32, device=u.device)
    if cfg.rotate_p > 0:
        angle = angle + torch.where(
            u[0] < cfg.rotate_p,
            _rng(u[1], -cfg.rotate_limit, cfg.rotate_limit), 0.0)
    if cfg.scale_p > 0 and cfg.scale_mode == "zoom":
        scale = scale * torch.where(
            u[2] < cfg.scale_p,
            1.0 + _rng(u[3], -cfg.scale_limit, cfg.scale_limit), 1.0)
    if cfg.shift_scale_rotate_p > 0:
        do = u[4] < cfg.shift_scale_rotate_p
        angle = angle + torch.where(
            do, _rng(u[5], -cfg.ssr_rotate_limit, cfg.ssr_rotate_limit), 0.0)
        scale = scale * torch.where(
            do, 1.0 + _rng(u[6], -cfg.ssr_scale_limit, cfg.ssr_scale_limit),
            1.0)
        ty = ty + torch.where(
            do, _rng(u[7], -cfg.ssr_shift_limit, cfg.ssr_shift_limit) * H,
            0.0)
        tx = tx + torch.where(
            do, _rng(u[8], -cfg.ssr_shift_limit, cfg.ssr_shift_limit) * W,
            0.0)
    return angle, scale, ty, tx


def _brightness_contrast(img, do, alpha, beta):
    return torch.where(do, torch.clamp(img * alpha + beta, 0, 255), img)


def _hsv_shift(img, do, dh, ds, dv):
    h, s, v = _rgb_to_hsv(img / 255.0)
    out = _hsv_to_rgb(torch.remainder((h[..., None] + dh)[..., 0], 1.0),
                      torch.clamp((s[..., None] + ds)[..., 0], 0, 1),
                      torch.clamp((v[..., None] + dv)[..., 0], 0, 1))
    return torch.where(do, torch.clamp(out * 255.0, 0, 255), img)


_BLUR_OFFSETS = (((0, -1), (0, 1)),      # horizontal
                 ((-1, 0), (1, 0)),      # vertical
                 ((-1, -1), (1, 1)),     # diagonal
                 ((-1, 1), (1, -1)))     # anti-diagonal


def _motion_blur(img, do, d):
    """3-tap line blur in direction d (one per batch, a 0-dim int tensor
    in 0..3), gated per sample. The four directions are blurred and one
    is picked on the device: the roll offsets are shapes of the ops, and
    reading d on the host would sync the step."""
    cands = [(img + torch.roll(img, a, dims=(1, 2))
              + torch.roll(img, b, dims=(1, 2))) / 3.0
             for a, b in _BLUR_OFFSETS]
    blurred = torch.stack(cands).index_select(0, d.reshape(1))[0]
    return torch.where(do, blurred, img)


def draw_augment(gen: torch.Generator, B: int, H: int, W: int,
                 cfg: AugmentConfig, device):
    """The draws of one batch of B rows, in order: U [17,B] uniforms (every
    small per-sample draw, as JAX), u [9] (the warp's; None without a
    warp) and noise [B,H,W,3] standard normals (None without the noise
    op)."""
    if cfg.per_sample_warp:
        raise NotImplementedError(
            "per_sample_warp is not ported (ROADMAP.md Queue 1 item 11)")
    U = torch.rand((17, B), generator=gen, device=device)
    u = torch.rand((9,), generator=gen, device=device) if cfg.any_warp \
        else None
    noise = torch.randn((B, H, W, 3), generator=gen, device=device) \
        if cfg.noise_p > 0 else None
    return U, u, noise


def augment_batch(gen: torch.Generator, images_u8, masks,
                  cfg: AugmentConfig, rows: slice = None,
                  batch: int = None):
    """[b,H,W,3] uint8 + [b,H,W,1] float -> (normalized float32 images,
    float32 masks), all on the device of the inputs and of `gen`.

    Under data parallelism the inputs are `rows` of a global batch of
    `batch` rows: the draws are made at the global size from the same
    generator state on every rank, and each rank takes its rows, so its
    augmentation of global row i is the single-process one. The batch's
    shared draws (the warp, the blur's direction: the global row 0's)
    are every rank's."""
    B, H, W, _ = images_u8.shape
    U, u, noise = draw_augment(gen, B if batch is None else batch, H, W,
                               cfg, images_u8.device)
    blur_u = U[16, 0]
    if rows is not None:
        U = U[:, rows]
        noise = noise[rows] if noise is not None else None
    return apply_augment(images_u8, masks, cfg, U, u, noise, blur_u)


def apply_augment(images_u8, masks, cfg: AugmentConfig, U: torch.Tensor,
                  u, noise, blur_u=None):
    """The pipeline at given draws: U [17,B] and u [9] uniforms in [0,1),
    noise [B,H,W,3] standard normals (u / noise may be None when their
    ops are off), blur_u the uniform of the blur's direction (U[16, 0]
    when None). augment_batch draws them; the tests give JAX's."""
    B, H, W, _ = images_u8.shape
    img = images_u8
    masks = masks.to(torch.float32)
    col = lambda x: x[:, None, None, None]  # noqa: E731

    if cfg.hflip_p > 0:
        do = col(U[0] < cfg.hflip_p)
        img = torch.where(do, img.flip(2), img)
        masks = torch.where(do, masks.flip(2), masks)

    if cfg.any_warp:
        angle, scale, ty, tx = draw_warp_params(u, cfg, H, W)
        img, masks = _shared_affine_warp(img, masks, angle, scale, ty, tx)
    else:
        img = img.to(torch.float32)

    if cfg.brightness_contrast_p > 0:
        img = _brightness_contrast(
            img, col(U[1] < cfg.brightness_contrast_p),
            col(1.0 + _rng(U[2], -cfg.contrast_limit, cfg.contrast_limit)),
            col(_rng(U[3], -cfg.brightness_limit, cfg.brightness_limit)
                * 255.0))

    if cfg.hsv_p > 0:
        img = _hsv_shift(
            img, col(U[4] < cfg.hsv_p),
            col(_rng(U[5], -cfg.hue_shift, cfg.hue_shift) / 180.0),
            col(_rng(U[6], -cfg.sat_shift, cfg.sat_shift) / 255.0),
            col(_rng(U[7], -cfg.val_shift, cfg.val_shift) / 255.0))

    if cfg.color_jitter_p > 0:
        do = col(U[8] < cfg.color_jitter_p)
        br = col(1.0 + _rng(U[9], -cfg.cj_brightness, cfg.cj_brightness))
        ct = col(1.0 + _rng(U[10], -cfg.cj_contrast, cfg.cj_contrast))
        st = col(1.0 + _rng(U[11], -cfg.cj_saturation, cfg.cj_saturation))
        hu = col(_rng(U[12], -cfg.cj_hue, cfg.cj_hue))
        out = img * br
        mean = out.mean(dim=(1, 2, 3), keepdim=True)
        out = torch.clamp((out - mean) * ct + mean, 0, 255)
        h, s, v = _rgb_to_hsv(out / 255.0)
        out = _hsv_to_rgb(torch.remainder((h[..., None] + hu)[..., 0], 1.0),
                          torch.clamp((s[..., None] * st)[..., 0], 0, 1), v)
        img = torch.where(do, torch.clamp(out * 255.0, 0, 255), img)

    if cfg.noise_p > 0:
        do = col(U[13] < cfg.noise_p)
        var = col(_rng(U[14], cfg.noise_var[0], cfg.noise_var[1]))
        img = torch.where(do, torch.clamp(img + noise * torch.sqrt(var),
                                          0, 255), img)

    if cfg.motion_blur_p > 0:
        blur_u = U[16, 0] if blur_u is None else blur_u
        d = torch.clamp((blur_u * 4.0).to(torch.int64), max=3)
        img = _motion_blur(img, col(U[15] < cfg.motion_blur_p), d)

    return normalize_batch(img, cfg.mean, cfg.std), masks
