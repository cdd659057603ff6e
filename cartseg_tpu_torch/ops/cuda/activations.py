"""Mish, swish and hard-swish, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Counterpart of cartseg_tpu/ops/pallas/activations.py (`_mish_fwd_kernel`
... `_hswish_bwd_kernel`). On float32 x (and upstream g), `act_fwd`
returns f(x) and `act_bwd` returns g * f'(x): the backward kernel takes
g, where the TPU's wrote f'(x) for the custom VJP to multiply. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel (csrc/activations.cu) or raises. Nothing falls back. Each
(activation, direction) counts in its own `LAUNCHES` key, `mish_fwd` ...
`hswish_bwd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from cartseg_tpu_torch.ops.cuda import build as B

KINDS = ("mish", "swish", "hswish")
# hswish's division by 6 as XLA compiles the Pallas kernel (and as
# PyTorch's CUDA division by a Python number runs): a multiplication by
# float32(1/6), the same on the CPU and in the kernel
_SIXTH = 1.0 / 6.0


def _softplus20(x):
    """activations.py:73-74: x above 20, else log1p(exp(min(x, 20)))."""
    return torch.where(x > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def act_fwd_plain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """f(x) as the TPU's forward kernels write it."""
    if kind == "mish":
        return x * torch.tanh(_softplus20(x))
    if kind == "swish":
        return x / (1.0 + torch.exp(-x))
    if kind == "hswish":
        return x * torch.clamp(x + 3.0, 0.0, 6.0) * _SIXTH
    raise ValueError(f"unknown activation {kind!r}")


def act_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """g * f'(x), with f'(x) as the TPU's backward kernels write it."""
    if kind == "mish":
        t = torch.tanh(_softplus20(x))
        d = t + x * (1.0 - t * t) * _sigmoid(x)
    elif kind == "swish":
        s = _sigmoid(x)
        d = s + x * s * (1.0 - s)
    elif kind == "hswish":
        d = torch.where(x <= -3.0, 0.0,
                        torch.where(x >= 3.0, 1.0, (2.0 * x + 3.0) * _SIXTH))
    else:
        raise ValueError(f"unknown activation {kind!r}")
    return g * d


def _launch(x: torch.Tensor, g: Optional[torch.Tensor], kind: str,
            what: str) -> torch.Tensor:
    if kind not in KINDS:
        raise ValueError(f"unknown activation {kind!r}")
    ts = (x,) if g is None else (x, g)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: need float32, got {t.dtype}")
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: tensors on "
                             f"{[str(u.device) for u in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"{what}: need x and g of one shape, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = B.load_library()
    with torch.cuda.device(x.device):
        rc = lib.cartseg_activation(
            KINDS.index(kind), x.data_ptr(),
            None if g is None else g.data_ptr(), out.data_ptr(), x.numel(),
            B.aligned16(*ts, out), B.stream_of(x))
    B.check(rc, what)
    B.LAUNCHES[f"{kind}_{'fwd' if g is None else 'bwd'}"] += 1
    return out


def act_fwd(x: torch.Tensor, kind: str) -> torch.Tensor:
    """f(x), float32. CUDA: csrc/activations.cu; CPU: `act_fwd_plain`."""
    if x.device.type == "cpu":
        return act_fwd_plain(x, kind)
    return _launch(x, None, kind, f"{kind} forward")


def act_bwd(x: torch.Tensor, g: torch.Tensor, kind: str) -> torch.Tensor:
    """g * f'(x), float32. CUDA: csrc/activations.cu; CPU:
    `act_bwd_plain`."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return act_bwd_plain(x, g, kind)
    return _launch(x, g, kind, f"{kind} backward")
