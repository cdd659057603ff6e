"""Connected components (counterpart of
cartseg_tpu/ops/connected_components.py): the replacement for
cv2.connectedComponentsWithStats in the pseudo-label cleanup
(create_pseudo_labels.py:124-138), the mask cleaners
(remove_blops.py:14-33, clean_complete.py:85-91) and hard-case mining
(mine_hard_cases.py:93-95).

Labels are the minimum flat pixel index of each component, H*W on
background, 8-connectivity unless asked otherwise. Labeling runs in
the CUDA union-find kernel on the card (ops/cuda/cc.py).

The statistics work per image over [..., H, W], on either device: a
component's area is one `torch.bincount` over b * (H*W + 1) + label,
"does any pixel of my component carry a flag" one `scatter_reduce`
(amax) over the same keys. The JAX package's RLE and pixel-sort lanes
(ops/cc_stats_rle.py, connected_components.py:235-330) exist only
because scatter serialised on the TPU; a histogram is the direct form
of the same statistic.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.cc import cc_batch


def connected_components(mask: torch.Tensor,
                         connectivity: int = 8) -> torch.Tensor:
    """[..., H, W] bool -> int32 labels of the same shape."""
    H, W = mask.shape[-2:]
    lab = cc_batch(mask.reshape(-1, H, W).contiguous(), connectivity)
    return lab.reshape(mask.shape)


def _keys(labels: torch.Tensor) -> tuple:
    """int64 keys [N, H*W], one per (image, label), and their count."""
    H, W = labels.shape[-2:]
    n = H * W
    flat = labels.reshape(-1, n).to(torch.int64)
    key = flat + (n + 1) * torch.arange(
        flat.shape[0], device=labels.device).unsqueeze(1)
    return key, flat.shape[0] * (n + 1)


def _areas(labels: torch.Tensor) -> torch.Tensor:
    key, bins = _keys(labels)
    counts = torch.bincount(key.reshape(-1), minlength=bins)
    return counts[key].reshape(labels.shape)


def per_pixel_component_area(labels: torch.Tensor) -> torch.Tensor:
    """int32 [..., H, W]: the pixel count of each pixel's component;
    background pixels get their image's background count (callers mask
    with fg), as the JAX function does."""
    return _areas(labels).to(torch.int32)


def per_pixel_component_any(labels: torch.Tensor,
                            flags: torch.Tensor) -> torch.Tensor:
    """bool [..., H, W]: does any pixel with my label (in my image) have
    its flag set? Background pixels form one group per image."""
    key, bins = _keys(labels)
    hit = torch.zeros(bins, dtype=torch.uint8, device=labels.device)
    hit.scatter_reduce_(0, key.reshape(-1),
                        flags.reshape(-1).to(torch.uint8), "amax")
    return hit[key].reshape(labels.shape).to(torch.bool)


def component_area_at_least(labels: torch.Tensor,
                            min_area: int) -> torch.Tensor:
    """bool [..., H, W]: does the pixel's fg component have >= min_area
    pixels? Background is always False."""
    H, W = labels.shape[-2:]
    return (_areas(labels) >= min_area) & (labels < H * W)


def remove_small_components(mask: torch.Tensor,
                            min_area: int) -> torch.Tensor:
    """Drop fg components below min_area pixels — `clean_mask`
    (create_pseudo_labels.py:124-138)."""
    labels = connected_components(mask)
    return mask & component_area_at_least(labels, min_area)


def count_components(mask: torch.Tensor) -> torch.Tensor:
    """int64 [...]: the number of 8-connected fg components of each
    [H, W] image (its roots: labels equal to their flat index)."""
    mask = mask.to(torch.bool)
    H, W = mask.shape[-2:]
    labels = connected_components(mask)
    idx = torch.arange(H * W, dtype=torch.int32,
                       device=mask.device).reshape(H, W)
    return (mask & (labels == idx)).sum((-2, -1))


def keep_largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Keep only each image's largest 8-connected fg component
    (remove_blops.py:14-33, clean_complete.py:85-91). On an area tie the
    smallest label wins, as cv2 keeps its first component; an empty
    image stays empty."""
    mask = mask.to(torch.bool)
    H, W = mask.shape[-2:]
    n = H * W
    if mask.numel() == 0:
        return mask
    labels = connected_components(mask)
    area = torch.where(mask, _areas(labels), 0).reshape(-1, n)
    labels, m = labels.reshape(-1, n), mask.reshape(-1, n)
    best = area.amax(1, keepdim=True)
    first = torch.where(m & (area == best), labels, n).amin(1, keepdim=True)
    return (m & (labels == first) & (best > 0)).reshape(mask.shape)
