"""Flash attention with SAM's decomposed relative-position bias, forward:
the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of cartseg_tpu/ops/pallas/flash_attention.py (`_kernel`, the
forward). For q, k, v [bnh, S, hd] with S = g*g and the two bias factors
rel_h, rel_w [bnh, S, g]:

    out = softmax(scale * q @ k^T + bias) @ v,
    bias[i, kh*g + kw] = rel_h[i, kh] + rel_w[i, kw],

with an fp32 softmax whatever the input type and the output in q's type.
A wrapper given CPU tensors runs the plain version (differentiable by
autograd); given CUDA tensors it launches the kernel (csrc/
flash_relpos.cu) or raises. Nothing falls back. The kernel has no
backward yet: a backward through it raises.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda import build as B

HEAD_DIMS = (32, 64)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_relpos_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rel_h: torch.Tensor,
                           rel_w: torch.Tensor, scale: float,
                           grid_size: int) -> torch.Tensor:
    """The kernel's function with the (bnh, S, S) logits materialised:
    fp32 logits (scale on the product, as the kernel), fp32 softmax, fp32
    product with v, cast to q's type."""
    bnh, S, _ = q.shape
    f = torch.float32
    logits = (q.to(f) @ k.to(f).transpose(1, 2)) * scale
    bias = rel_h.to(f)[:, :, :, None] + rel_w.to(f)[:, :, None, :]
    logits = logits + bias.reshape(bnh, S, S)
    p = torch.softmax(logits, dim=-1)
    return (p @ v.to(f)).to(q.dtype)


def _check(q, k, v, rel_h, rel_w, grid_size: int) -> None:
    what = "flash_relpos_fwd"
    ts = (q, k, v, rel_h, rel_w)
    if q.dim() != 3:
        raise ValueError(f"{what}: need q [bnh,S,hd], got {tuple(q.shape)}")
    bnh, S, hd = q.shape
    g = int(grid_size)
    if S != g * g:
        raise ValueError(f"{what}: S = {S} is not grid_size^2 = {g * g}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"must match q {tuple(q.shape)}")
    if rel_h.shape != (bnh, S, g) or rel_w.shape != (bnh, S, g):
        raise ValueError(f"{what}: need rel_h, rel_w [{bnh},{S},{g}], got "
                         f"{tuple(rel_h.shape)}, {tuple(rel_w.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: need one type, float32 or bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: tensors must start 16-byte aligned")
    if bnh > 65535:
        raise ValueError(f"{what}: bnh {bnh} above the grid's 65535")


def flash_relpos_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor, scale: float,
                     grid_size: int) -> torch.Tensor:
    """[bnh,S,hd] attention output. CUDA: csrc/flash_relpos.cu; CPU:
    `flash_relpos_fwd_plain`. No autograd on the CUDA lane (see
    `flash_attention_relpos` in ops/flash_attention.py)."""
    if all(t.device.type == "cpu" for t in (q, k, v, rel_h, rel_w)):
        return flash_relpos_fwd_plain(q, k, v, rel_h, rel_w, scale,
                                      grid_size)
    _check(q, k, v, rel_h, rel_w, grid_size)
    bnh, S, hd = q.shape
    lib = B.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.cartseg_flash_relpos_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), out.data_ptr(), bnh, S, int(grid_size), hd,
            int(q.dtype == torch.bfloat16), float(scale), B.stream_of(q))
    B.check(rc, "flash_relpos_fwd")
    B.LAUNCHES["flash_fwd"] += 1
    return out
