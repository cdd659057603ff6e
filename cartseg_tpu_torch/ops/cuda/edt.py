"""Jump-flood EDT: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of cartseg_tpu/ops/pallas/edt.py (`edt_batch_pallas`), with
the semantics of the JAX XLA lane, cartseg_tpu/ops/edt.py:34-86 (1+JFA:
the distance from every pixel to the nearest True seed, sqrt(1e12) = 1e6
where a sample has no seed). A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (csrc/edt.cu) or
raises. Nothing falls back.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda import build as B
from cartseg_tpu_torch.ops.cuda.cc import _shift_fill

_INF = 1e12
# squared distances stay exact in float32 and in int32 below this side
_MAX_SIDE = 2048


def jfa_steps(h: int, w: int) -> list:
    """k = 2^floor(log2(max(h,w)-1)) ... 1, then 1 again (`_jfa_steps`,
    cartseg_tpu/ops/pallas/edt.py:43-53)."""
    n = max(h, w)
    k = 1
    while k * 2 < n:
        k *= 2
    steps = []
    while k >= 1:
        steps.append(k)
        k //= 2
    return steps + [1]


def edt_batch_plain(seeds: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool -> [B,H,W] float32, op for op the JAX `edt`
    (ops/edt.py:39-86) over a batch axis: int32 nearest-seed
    coordinates, float32 squared distances, the 8 candidates of a step
    applied one after another, replacement on strict `<`."""
    seeds = seeds.to(torch.bool)
    _, H, W = seeds.shape
    dev = seeds.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    by = torch.where(seeds, ys, zero)
    bx = torch.where(seeds, xs, zero)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    d2 = torch.where(seeds, torch.zeros((), device=dev), inf)
    for k in jfa_steps(H, W):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cby = _shift_fill(by, dy, dx, 0)
                cbx = _shift_fill(bx, dy, dx, 0)
                cd2 = _shift_fill(d2, dy, dx, _INF)
                nd2 = torch.where(
                    cd2 < inf,
                    ((ys - cby) ** 2 + (xs - cbx) ** 2).to(torch.float32),
                    inf)
                better = nd2 < d2
                by = torch.where(better, cby, by)
                bx = torch.where(better, cbx, bx)
                d2 = torch.where(better, nd2, d2)
    # the correctly rounded float32 sqrt (XLA's and the kernel's sqrtf):
    # torch's vectorised float32 sqrt on the CPU is off by an ulp on some
    # integers, and a float64 sqrt rounded once to float32 is exact
    # (53 >= 2*24 + 2 bits)
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def edt_batch_jfa(seeds: torch.Tensor) -> torch.Tensor:
    """[B,H,W] bool seeds -> [B,H,W] float32 distances. CUDA: the
    jump-flood kernel (csrc/edt.cu); CPU: `edt_batch_plain`."""
    if seeds.dim() != 3:
        raise ValueError(f"edt_batch_jfa: need [B,H,W], got "
                         f"{tuple(seeds.shape)}")
    if seeds.dtype != torch.bool:
        raise TypeError(f"edt_batch_jfa: need bool seeds, got {seeds.dtype}")
    if seeds.device.type == "cpu":
        return edt_batch_plain(seeds)
    if not seeds.is_cuda:
        raise ValueError(f"edt_batch_jfa: tensor on {seeds.device}")
    if not seeds.is_contiguous():
        raise ValueError("edt_batch_jfa: tensor must be contiguous")
    Bn, H, W = seeds.shape
    if H > _MAX_SIDE or W > _MAX_SIDE:
        raise ValueError(f"edt_batch_jfa: side above {_MAX_SIDE}: "
                         f"{tuple(seeds.shape)}")
    a = torch.empty(seeds.shape, dtype=torch.int32, device=seeds.device)
    b = torch.empty_like(a)
    out = torch.empty(seeds.shape, dtype=torch.float32, device=seeds.device)
    lib = B.load_library()
    with torch.cuda.device(seeds.device):
        rc = lib.cartseg_edt(seeds.data_ptr(), a.data_ptr(), b.data_ptr(),
                             out.data_ptr(), Bn, H, W, B.stream_of(seeds))
    B.check(rc, "edt_batch_jfa")
    B.LAUNCHES["edt"] += 1
    return out
