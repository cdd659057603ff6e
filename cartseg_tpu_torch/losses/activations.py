"""Activation ops from the reference CUDA zoo (mish_kernel.cu,
swish_kernel.cu), counterpart of cartseg_tpu/losses/activations.py.

Each is a torch.autograd.Function over the hand-written CUDA kernels of
the JAX package's Pallas activations (ops/cuda/activations.py; ROADMAP
Queue 2 #10) on the card and their plain versions on the CPU. As the
Pallas lane does (activations.py:47-71 there), the math runs in float32
and the result is cast back to the input's dtype; the backward needs
only x, and its kernel writes g * f'(x) in one pass. Mish keeps the
Pallas kernels' softplus with the x > 20 guard (EXP_THRESH), where the
JAX package's XLA form uses jax.nn.softplus.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.activations import act_bwd, act_fwd


class _Activation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.save_for_backward(x)
        ctx.kind = kind
        return act_fwd(x.to(torch.float32).contiguous(), kind).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        grad = act_bwd(x.to(torch.float32).contiguous(),
                       g.to(torch.float32).contiguous(), ctx.kind)
        return grad.to(x.dtype), None


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) - mish_kernel.cu:10-25."""
    return _Activation.apply(x, "mish")


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) - swish_kernel.cu."""
    return _Activation.apply(x, "swish")


def hswish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6 - hswish in swish_kernel.cu:259-263."""
    return _Activation.apply(x, "hswish")
