"""Edge maps and boundaries (counterpart of cartseg_tpu/ops/edges.py):
the device stand-in for the reference's cv2 Canny/findContours QC gate
(create_pseudo_labels.py:178-189).

`canny_edges` mirrors cv2.Canny(gray, low, high): Sobel-3 with
replicate border, L1 magnitude, 4-sector non-maximum suppression, and
double-threshold hysteresis. `sobel_edges`, the cheaper single-threshold
gate, takes the L2 magnitude of a Sobel-3 with zero padding (the JAX
`_conv3`'s "SAME"), not Canny's replicate border. Hysteresis runs the reach kernel
(ops/cuda/cc.py) to a full fixpoint, as the TPU kernel did. The JAX
CPU lane (`_hysteresis`, edges.py:118-146) instead stops after 256
dilation steps, so at 512x512 a weak chain longer than 256 px can
differ from that capped lane; images that converge within the cap
agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cartseg_tpu_torch.ops.cuda.cc import _shift_fill, reach_batch
from cartseg_tpu_torch.ops.morphology import erode

_GRAY = (0.299, 0.587, 0.114)
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] (uint8 or float) -> [..., H, W] float32, BT.601
    weights (cv2.cvtColor RGB2GRAY)."""
    w = torch.tensor(_GRAY, dtype=torch.float32, device=rgb.device)
    return rgb.to(torch.float32) @ w


def _sobel_kernels(device) -> torch.Tensor:
    kx = torch.tensor(_SOBEL_X, dtype=torch.float32, device=device)
    return torch.stack([kx, kx.T]).unsqueeze(1)          # [2,1,3,3]


def _sobel_replicate(gray: torch.Tensor):
    """Sobel-3 (gx, gy) with replicate border, batched over leading
    dims; float32."""
    H, W = gray.shape[-2:]
    g = gray.to(torch.float32).reshape(-1, 1, H, W)
    g = F.pad(g, (1, 1, 1, 1), mode="replicate")
    out = F.conv2d(g, _sobel_kernels(gray.device))      # cross-correlation
    return (out[:, 0].reshape(gray.shape), out[:, 1].reshape(gray.shape))


def sobel_edges(gray: torch.Tensor, threshold: float = 120.0) -> torch.Tensor:
    """[..., H, W] float gray (0..255) -> bool edge map at |grad| >=
    threshold: Sobel-3 with zero padding, L2 magnitude."""
    H, W = gray.shape[-2:]
    g = gray.to(torch.float32).reshape(-1, 1, H, W)
    out = F.conv2d(g, _sobel_kernels(gray.device), padding=1)
    gx, gy = out[:, 0], out[:, 1]
    return (torch.sqrt(gx * gx + gy * gy) >= threshold).reshape(gray.shape)


def _hysteresis(weak: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """weak pixels 8-connected to a strong pixel through weak pixels."""
    H, W = weak.shape[-2:]
    out = reach_batch(weak.reshape(-1, H, W).contiguous(),
                      strong.reshape(-1, H, W).contiguous())
    return out.reshape(weak.shape)


def canny_edges(gray: torch.Tensor, low: float = 50.0,
                high: float = 150.0) -> torch.Tensor:
    """[..., H, W] float gray (0..255) -> bool edge map."""
    return _hysteresis(*canny_weak_strong(gray, low, high))


def canny_weak_strong(gray: torch.Tensor, low: float = 50.0,
                      high: float = 150.0):
    """Canny up to the hysteresis input: the NMS-kept pixels above
    `low` (weak) and above `high` (strong)."""
    gx, gy = _sobel_replicate(gray)
    ax, ay = gx.abs(), gy.abs()
    mag = ax + ay
    tg22 = 0.4142135623730951  # tan(22.5 deg)
    horiz = ay <= tg22 * ax
    vert = ax <= tg22 * ay
    diag = ~(horiz | vert)
    same_sign = (gx * gy) >= 0.0

    def nb(dy, dx):
        return _shift_fill(mag, dy, dx, 0.0)

    keep_h = (mag > nb(0, 1)) & (mag >= nb(0, -1))
    keep_v = (mag > nb(1, 0)) & (mag >= nb(-1, 0))
    keep_d1 = (mag > nb(1, 1)) & (mag >= nb(-1, -1))
    keep_d2 = (mag > nb(1, -1)) & (mag >= nb(-1, 1))
    keep = torch.where(horiz, keep_h, torch.where(
        vert, keep_v, torch.where(same_sign & diag, keep_d1, keep_d2)))
    return keep & (mag > low), keep & (mag > high)


def mask_boundary(mask: torch.Tensor) -> torch.Tensor:
    """1-px inner boundary of a bool mask — the analog of
    drawContours(thickness=1) over RETR_EXTERNAL contours."""
    return mask & ~erode(mask, 3, shape="square")


def edge_hit_rate(rgb: torch.Tensor, mask: torch.Tensor,
                  threshold: float = 120.0, method: str = "canny",
                  low: float = 50.0, high: float = 150.0) -> torch.Tensor:
    """The share of mask-boundary pixels on an image edge (edge_hit_rate,
    create_pseudo_labels.py:178-189), 0.0 where the boundary is empty:
    rgb [..., H, W, 3], mask [..., H, W] -> float32 [...]. method
    'canny' (Canny(low, high), the reference's gate) or anything else
    for Sobel at `threshold`, as the JAX function reads it."""
    gray = rgb_to_gray(rgb)
    edges = canny_edges(gray, low, high) if method == "canny" else \
        sobel_edges(gray, threshold)
    boundary = mask_boundary(mask.to(torch.bool))
    tot = boundary.to(torch.float32).sum((-2, -1))
    hits = (edges & boundary).to(torch.float32).sum((-2, -1))
    return torch.where(tot > 0, hits / tot.clamp(min=1), 0.0)
