"""LayerNorm forward and backward (layer_norm.cu:390-392, part of the
reference op zoo, unused by its scripts), counterpart of
cartseg_tpu/losses/layer_norm.py: an autograd Function with the
standard hand-derived backward in place of the JAX custom VJP.
Normalizes over the last axis (channels-last) in float32 and returns
the input's dtype; weight and bias are arguments, as in JAX.
"""

from __future__ import annotations

import torch


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x32 = x.to(torch.float32)
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (x32 - mean) * rstd
        ctx.save_for_backward(xhat, rstd, weight, bias)
        ctx.dtype = x.dtype
        return (xhat * weight + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xhat, rstd, weight, bias = ctx.saved_tensors
        g = g.to(torch.float32)
        gw = g * weight
        # dL/dx = rstd * (gw - mean(gw) - xhat * mean(gw * xhat))
        m1 = gw.mean(-1, keepdim=True)
        m2 = (gw * xhat).mean(-1, keepdim=True)
        dx = (rstd * (gw - m1 - xhat * m2)).to(ctx.dtype)
        axes = tuple(range(xhat.dim() - 1))
        dw = (g * xhat).sum(axes).to(weight.dtype)
        db = g.sum(axes).to(bias.dtype)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * weight + bias over the last axis."""
    return _LayerNorm.apply(x, weight, bias, eps)
