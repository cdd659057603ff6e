"""Flash attention with decomposed relative-position bias, the SAM ViT
global blocks' attention (counterpart of
cartseg_tpu/ops/pallas/flash_attention.py).

`supported` is the JAX package's predicate, so the port sends the same
blocks to this lane as JAX does (models/sam.py). `flash_attention_relpos`
runs the hand-written CUDA kernels on CUDA tensors (ops/cuda/
flash_attention.py) and `flash_attention_relpos_plain` on CPU tensors.
Both lanes are differentiable. On the card an autograd Function, the
counterpart of JAX's custom VJP `_flash`, runs the forward kernel (which
writes the logsumexp only when a gradient is needed) and, in its
backward, the two backward kernels (dq/drel_h/drel_w, dk/dv); it never
calls a plain version. The CPU lane is autograd through the plain
forward.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.flash_attention import (flash_relpos_bwd,
                                                        flash_relpos_fwd)
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
    """The CUDA kernels behind autograd (JAX: `_flash` and its VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, grid_size):
        # grad mode is off in here: needs_input_grad says whether the
        # backward will run, and so whether the forward writes the lse
        ctx.scale, ctx.grid_size = scale, grid_size
        if not any(ctx.needs_input_grad[:5]):
            return flash_relpos_fwd(q, k, v, rel_h, rel_w, scale, grid_size)
        out, lse = flash_relpos_fwd(q, k, v, rel_h, rel_w, scale, grid_size,
                                    with_lse=True)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        # the gradient through models/sam.py's reshape + permute of the
        # output arrives strided; the kernels read dense rows
        grads = flash_relpos_bwd(*ctx.saved_tensors, grad_out.contiguous(),
                                 ctx.scale, ctx.grid_size)
        return (*grads, None, None)


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
