"""BatchNorm in two lanes, both with flax's running-statistics update
(counterpart of cartseg_tpu/models/norm.py).

Lane "torch" (the default): `BatchNorm2d`, torch's fused batch norm.
Train mode normalises with the biased batch variance in both
frameworks, and torch's momentum 0.1 is flax's 0.9. They differ in the
running variance: flax blends in the biased batch variance
(norm.py:113-118, flax.linen.BatchNorm), stock `nn.BatchNorm2d` the
unbiased one, n / (n - 1) times larger. `BatchNorm2d` here keeps
torch's fused kernel and corrects the running variance afterwards in
O(C): with rv0 the old value, u the unbiased and b = u (n-1)/n the
biased batch variance, torch stores r = (1-m) rv0 + m u, and flax's
value is (1-m) rv0 + m b = ((n-1) r + (1-m) rv0) / n.

Lane "channel_sums": `ChannelSumsBatchNorm2d`, the counterpart of
`TpuBatchNorm`: train mode's two full-tensor reductions per pass (sum x
and sum x^2 forward, sum dy and sum dy*x backward) run through
ops/channel_sums.py, the hand-written CUDA kernel on the card, and the
elementwise math follows `bn_train` op for op.

`batch_norm(num_features, eps, lane)` is the models' factory (the JAX
`batch_norm`, norm.py:134-140). The lane is an argument; the workloads'
entry point turns CARTSEG_PALLAS_BN into it (workloads/_runner.py).
Both lanes hold the same parameters and buffers, so a checkpoint loads
in either.

Activation recompute (the trainer's `remat`, torch.utils.checkpoint)
runs a train-mode forward a second time inside the backward. flax
returns `batch_stats` once from the forward, so while a model is
`recomputing(model)` (`remat_contexts`' second context, around that
rerun) its BN layers in both lanes normalise with the batch's
statistics as before and leave the running statistics and the batch
counter as the forward left them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.ops.channel_sums import channel_sums
from cartseg_tpu_torch.ops.cuda.channel_sums import memory_order

BN_LANES = ("torch", "channel_sums")


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance follows flax."""

    recompute = False   # set by `recomputing`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats
                and self.momentum is not None):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # the op updates (and autograd may keep) its own copy r; the
        # buffer takes flax's value from r and the old value rv0
        r = self.running_var.clone()
        if self.recompute:
            # the same op on copies (the same kernel, so the same output);
            # the buffers keep the forward's update
            return F.batch_norm(x, self.running_mean.clone(), r,
                                self.weight, self.bias, True, m, self.eps)
        y = F.batch_norm(x, self.running_mean, r, self.weight, self.bias,
                         True, m, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_var.mul_(1.0 - m).add_(r, alpha=n - 1).div_(n)
        return y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _dense(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t in like's memory order, contiguous if like is strided (a no-op
    when it already is): the kernel reads both inputs in one order."""
    fmt = (torch.channels_last if memory_order(like) == "nhwc"
           else torch.contiguous_format)
    return t.contiguous(memory_format=fmt)


class BNTrain(torch.autograd.Function):
    """Train-mode batch norm over (N, H, W) (`bn_train`, norm.py:38-89):
    returns (y, mean, var) with mean and var fp32 [C] (biased variance).
    mean and var feed the running statistics only and take no gradient,
    as in JAX. The elementwise math runs in x's type with autocast off:
    autocast would lift rsqrt to fp32 where flax computes in bf16."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if x.dim() != 4:
            raise ValueError(f"BNTrain: need [N,C,H,W], got {tuple(x.shape)}")
        with torch.autocast(x.device.type, enabled=False):
            x = _dense(x, x)
            n = x.numel() // x.shape[1]
            s, ss = channel_sums(x, x)
            mean = s / n
            var = ss / n - mean * mean
            dt = x.dtype
            mul = weight.to(dt) * torch.rsqrt(var.to(dt) + eps)
            y = ((x - _per_channel(mean.to(dt))) * _per_channel(mul)
                 + _per_channel(bias.to(dt)))
            rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            n = x.numel() // x.shape[1]
            dy = _dense(dy.to(x.dtype), x)
            s_dy, s_dyx = channel_sums(dy, x)
            dbeta = s_dy
            dgamma = rstd * (s_dyx - mean * s_dy)
            # dx = (gamma*rstd) * (dy - dbeta/n - xhat * dgamma/n), folded
            # into a*dy - d*x + b over per-channel fp32 coefficients
            a = weight * rstd
            d = a * rstd * (dgamma / n)
            b = -a * (dbeta / n) + d * mean
            dt = x.dtype
            dx = (_per_channel(a.to(dt)) * dy - _per_channel(d.to(dt)) * x
                  + _per_channel(b.to(dt)))
        return dx, dgamma, dbeta, None


class ChannelSumsBatchNorm2d(nn.BatchNorm2d):
    """Counterpart of `TpuBatchNorm` (cartseg_tpu/models/norm.py:92-119):
    train mode through `BNTrain` (the channel-sums kernel on the card),
    flax's running-statistics update with the biased variance (torch's
    momentum 0.1 is flax's 0.9), and eval mode as norm.py:108-112 in the
    input's type. Parameter and buffer names are nn.BatchNorm2d's."""

    recompute = False   # set by `recomputing`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            with torch.autocast(x.device.type, enabled=False):
                dt = x.dtype
                mul = self.weight.to(dt) * torch.rsqrt(
                    self.running_var.to(dt) + self.eps)
                return ((x - _per_channel(self.running_mean.to(dt)))
                        * _per_channel(mul) + _per_channel(self.bias.to(dt)))
        y, mean, var = BNTrain.apply(x, self.weight, self.bias, self.eps)
        if self.recompute:
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def recomputing(model: nn.Module):
    """The forward run inside this block reruns one that already ran:
    model's BN layers update no running statistics."""
    bns = [m for m in model.modules()
           if isinstance(m, (BatchNorm2d, ChannelSumsBatchNorm2d))]
    for m in bns:
        m.recompute = True
    try:
        yield
    finally:
        for m in bns:
            m.recompute = False


def remat_contexts(model: nn.Module):
    """torch.utils.checkpoint's `context_fn` for model (bind it with
    functools.partial): nothing around the forward, `recomputing(model)`
    around its rerun."""
    return contextlib.nullcontext(), recomputing(model)


def batch_norm(num_features: int, eps: float, lane: str = "torch"
               ) -> nn.BatchNorm2d:
    """The models' norm factory: `BatchNorm2d` in the "torch" lane,
    `ChannelSumsBatchNorm2d` in the "channel_sums" lane."""
    if lane == "torch":
        return BatchNorm2d(num_features, eps=eps)
    if lane == "channel_sums":
        return ChannelSumsBatchNorm2d(num_features, eps=eps)
    raise ValueError(f"unknown BN lane {lane!r} (one of {BN_LANES})")
