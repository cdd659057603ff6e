"""Label-smoothed softmax CE, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Counterpart of cartseg_tpu/ops/pallas/lsr.py (`_fwd_kernel`,
`_bwd_kernel`). Logits [N, C] float32 row-major, labels [N] int; rows
whose label equals `ignore_index` give loss 0 and gradient 0. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel (csrc/lsr.cu) or raises. Nothing falls back.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda import build as B


def _smoothing(C: int, lb_smooth: float):
    lb_pos = 1.0 - lb_smooth
    lb_neg = lb_smooth / C
    return lb_pos, lb_neg


def lsr_fwd_plain(x: torch.Tensor, labels: torch.Tensor, lb_smooth: float,
                  ignore_index: int) -> torch.Tensor:
    """[N,C], [N] -> [N]: -(lb_neg * sum logp + (lb_pos - lb_neg) *
    logp[label]) (lsr.py:38-58)."""
    C = x.shape[-1]
    lb_pos, lb_neg = _smoothing(C, lb_smooth)
    logp = torch.log_softmax(x.to(torch.float32), dim=-1)
    ignore = labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(labels), labels)
    at = torch.arange(C, device=x.device) == safe.unsqueeze(-1)
    loss = -(lb_neg * logp.sum(-1)
             + (lb_pos - lb_neg) * torch.where(at, logp, 0.0).sum(-1))
    return torch.where(ignore, 0.0, loss)


def lsr_bwd_plain(x: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                  lb_smooth: float, ignore_index: int) -> torch.Tensor:
    """[N,C], [N], [N] -> [N,C]: g * (coeff * softmax - oh)
    (lsr.py:61-80)."""
    C = x.shape[-1]
    lb_pos, lb_neg = _smoothing(C, lb_smooth)
    coeff = (C - 1) * lb_neg + lb_pos
    p = torch.softmax(x.to(torch.float32), dim=-1)
    ignore = labels == ignore_index
    safe = torch.where(ignore, torch.zeros_like(labels), labels)
    at = torch.arange(C, device=x.device) == safe.unsqueeze(-1)
    oh = torch.where(at, lb_pos, lb_neg)
    grad = (coeff * p - oh) * g.unsqueeze(-1)
    return torch.where(ignore.unsqueeze(-1), 0.0, grad)


def _check(x: torch.Tensor, labels: torch.Tensor, what: str):
    if x.dim() != 2 or labels.shape != x.shape[:1]:
        raise ValueError(f"{what}: need x [N,C] and labels [N], got "
                         f"{tuple(x.shape)} and {tuple(labels.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: need float32 logits, got {x.dtype}")
    if not x.is_cuda or not labels.is_cuda:
        raise ValueError(f"{what}: tensors on {x.device} / {labels.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: logits must be contiguous")


def lsr_fwd(x: torch.Tensor, labels: torch.Tensor, lb_smooth: float,
            ignore_index: int) -> torch.Tensor:
    """Per-row LSR CE [N]. CUDA: csrc/lsr.cu `lsr_fwd`; CPU:
    `lsr_fwd_plain`."""
    if x.device.type == "cpu" and labels.device.type == "cpu":
        return lsr_fwd_plain(x, labels, lb_smooth, ignore_index)
    _check(x, labels, "lsr_fwd")
    n, C = x.shape
    lab = labels.to(torch.int32).contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    lb_pos, lb_neg = _smoothing(C, lb_smooth)
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_lsr_fwd(x.data_ptr(), lab.data_ptr(),
                                 out.data_ptr(), n, C, lb_pos, lb_neg,
                                 int(ignore_index), B.stream_of(x))
    B.check(rc, "lsr_fwd")
    B.LAUNCHES["lsr_fwd"] += 1
    return out


def lsr_bwd(x: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
            lb_smooth: float, ignore_index: int) -> torch.Tensor:
    """d(loss)/d(x) [N,C] for upstream g [N]. CUDA: csrc/lsr.cu
    `lsr_bwd`; CPU: `lsr_bwd_plain`."""
    if x.device.type == "cpu" and labels.device.type == "cpu":
        return lsr_bwd_plain(x, labels, g, lb_smooth, ignore_index)
    _check(x, labels, "lsr_bwd")
    n, C = x.shape
    lab = labels.to(torch.int32).contiguous()
    gf = g.to(torch.float32).contiguous()
    if gf.shape != (n,) or not gf.is_cuda:
        raise ValueError(f"lsr_bwd: g must be [N] on the card, got "
                         f"{tuple(gf.shape)} on {gf.device}")
    grad = torch.empty((n, C), dtype=torch.float32, device=x.device)
    lb_pos, lb_neg = _smoothing(C, lb_smooth)
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_lsr_bwd(x.data_ptr(), lab.data_ptr(), gf.data_ptr(),
                                 grad.data_ptr(), n, C, lb_pos, lb_neg,
                                 int(ignore_index), B.stream_of(x))
    B.check(rc, "lsr_bwd")
    B.LAUNCHES["lsr_bwd"] += 1
    return grad
