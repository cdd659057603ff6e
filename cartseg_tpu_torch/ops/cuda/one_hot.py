"""Smoothed one-hot rows: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/one_hot.py (`_kernel`,
`smooth_one_hot_pallas`). Integer labels [...] -> float32 [..., C]:
lb_pos = 1 - lb_smooth at the label, lb_neg = lb_smooth / C at every
other class, and all-zero rows where the label equals `ignore_index`;
both values are the float32 roundings of the Python numbers, as the TPU
kernel writes them. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (csrc/one_hot.cu)
or raises. Nothing falls back.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda import build as B

_LAB64 = {torch.int32: 0, torch.int64: 1}


def _values(num_classes: int, lb_smooth: float):
    return (torch.tensor(1.0 - lb_smooth, dtype=torch.float32),
            torch.tensor(lb_smooth / num_classes, dtype=torch.float32))


def one_hot_plain(labels: torch.Tensor, num_classes: int, lb_smooth: float,
                  ignore_index: int) -> torch.Tensor:
    """one_hot.py `_kernel` in channels-last order: a class row compared
    with the label (a label outside [0, C) gives a row of lb_neg)."""
    hi, lo = (v.to(labels.device) for v in _values(num_classes, lb_smooth))
    ignore = labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(labels), labels)
    at = safe.unsqueeze(-1) == torch.arange(num_classes,
                                            device=labels.device)
    return torch.where(ignore.unsqueeze(-1), 0.0, torch.where(at, hi, lo))


def one_hot(labels: torch.Tensor, num_classes: int, lb_smooth: float,
            ignore_index: int) -> torch.Tensor:
    """[...] int32 or int64 labels -> [..., C] float32. CUDA:
    csrc/one_hot.cu; CPU: `one_hot_plain`. Bit-equal to each other."""
    if labels.device.type == "cpu":
        return one_hot_plain(labels, num_classes, lb_smooth, ignore_index)
    if labels.dtype not in _LAB64:
        raise TypeError(f"one_hot: need int32 or int64 labels, got "
                        f"{labels.dtype}")
    if not labels.is_cuda:
        raise ValueError(f"one_hot: tensor on {labels.device}")
    if not labels.is_contiguous():
        raise ValueError("one_hot: labels must be contiguous")
    if num_classes <= 0:
        raise ValueError(f"one_hot: num_classes = {num_classes}")
    out = torch.empty(labels.shape + (num_classes,), dtype=torch.float32,
                      device=labels.device)
    if labels.numel() == 0:
        return out
    hi, lo = _values(num_classes, lb_smooth)
    vec = int(num_classes % 4 == 0 and B.aligned16(out))
    lib = B.load_library()
    with torch.cuda.device(labels.device):
        rc = lib.cartseg_one_hot(labels.data_ptr(), out.data_ptr(),
                                 labels.numel(), num_classes, float(hi),
                                 float(lo), int(ignore_index),
                                 _LAB64[labels.dtype], vec,
                                 B.stream_of(labels))
    B.check(rc, "one_hot")
    B.LAUNCHES["one_hot"] += 1
    return out
