"""Flash attention with decomposed relative-position bias, the SAM ViT
global blocks' attention (counterpart of
cartseg_tpu/ops/pallas/flash_attention.py).

`supported` is the JAX package's predicate, so the port sends the same
blocks to this lane as JAX does (models/sam.py). `flash_attention_relpos`
runs the hand-written CUDA kernel on CUDA tensors (ops/cuda/
flash_attention.py) and `flash_attention_relpos_plain` on CPU tensors.
The CUDA lane is forward only: its backward kernels (dq/drel, dk/dv) are
ROADMAP.md Queue 2 item 6, so a backward through it raises. The plain
lane is differentiable by autograd.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.flash_attention import flash_relpos_fwd
from cartseg_tpu_torch.ops.cuda.flash_attention import \
    flash_relpos_fwd_plain as flash_attention_relpos_plain

_LANES = 128


def supported(grid_size: int, seq: int, head_dim: int) -> bool:
    """Shapes the JAX kernel's tiling serves (SAM's global blocks do):
    cartseg_tpu/ops/pallas/flash_attention.py:133-138."""
    kb_rows = max(1, _LANES // grid_size)
    lanes = kb_rows * grid_size
    return (grid_size * grid_size == seq and seq % lanes == 0
            and head_dim % 8 == 0 and seq >= lanes)


class _FlashRelposCuda(torch.autograd.Function):
    """The CUDA forward behind autograd; its backward is not ported."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, grid_size):
        return flash_relpos_fwd(q, k, v, rel_h, rel_w, scale, grid_size)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention_relpos: the backward kernels (dq/drel_h/"
            "drel_w and dk/dv) are not ported yet (ROADMAP.md Queue 2 "
            "item 6); train through the plain lane on the CPU or set "
            "SamConfig.global_attn_flash=False")


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rel_h: torch.Tensor,
                           rel_w: torch.Tensor, *, scale: float,
                           grid_size: int) -> torch.Tensor:
    """softmax(q @ k^T * scale + bias) @ v without materialising the
    (bnh, S, S) logits on the card, bias[i, kh*g+kw] = rel_h[i, kh] +
    rel_w[i, kw]. q, k, v: [bnh, S, head_dim], S == grid_size**2; rel_h,
    rel_w: [bnh, S, grid_size]. Returns [bnh, S, head_dim] in q's type."""
    if all(t.device.type == "cpu" for t in (q, k, v, rel_h, rel_w)):
        return flash_attention_relpos_plain(q, k, v, rel_h, rel_w, scale,
                                            grid_size)
    return _FlashRelposCuda.apply(q, k, v, rel_h, rel_w, float(scale),
                                  int(grid_size))
