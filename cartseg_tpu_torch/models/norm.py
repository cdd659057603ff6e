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

Under data parallelism (`sync_batch_norm(model, group)`, set by the
trainer over a process group) train mode in both lanes takes the
statistics of the GLOBAL batch, as the JAX mesh does (GSPMD all-reduces
flax's batch means): `BNTrain` all-reduces (sum x, sum x^2) and the
element count after its sums in the forward, and (sum dy, sum dy*x) in
the backward, so the mean, the variance, dx and the running statistics
are the global ones on every rank; the sums run through the channel-sums
kernel. The torch lane takes `SyncBNTrain`, the same synced path over
plain per-channel sums, centred on the global mean as torch's own batch
norm centres its variance (a second all_reduce in the forward; sum x^2 -
n mean^2 in fp32 loses the variance of a channel whose mean is large
against its spread), with flax's biased running variance. Not
`nn.SyncBatchNorm`: it refuses CPU tensors, and its running variance is
torch's unbiased one. Each rank's dgamma and dbeta are its own rows'
share, from the local sums, as SyncBatchNorm's are: DDP averages the
ranks' gradients, so the shares' sum would count the global batch
world-size times. Every rank issues the same collectives in the same
order, only `all_reduce`, on the inputs' device.

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

import torch.distributed as dist

from cartseg_tpu_torch.ops.channel_sums import channel_sums
from cartseg_tpu_torch.ops.cuda.channel_sums import memory_order

BN_LANES = ("torch", "channel_sums")


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance follows flax."""

    recompute = False   # set by `recomputing`
    process_group = None  # set by `sync_batch_norm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats
                and self.momentum is not None):
            return super().forward(x)
        if self.process_group is not None:
            # the synced path, with flax's biased running variance
            y, mean, var = SyncBNTrain.apply(x, self.weight, self.bias,
                                             self.eps, self.process_group)
            if not self.recompute:
                _update_running(self, mean, var)
            return y
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


def _all_reduce_sums(group, *vs: torch.Tensor) -> list:
    """The [C] vectors summed over the group's ranks, each in its own
    type, through one float64 all_reduce (an element count of 2^24 and
    more stays exact)."""
    buf = torch.cat([v.to(torch.float64).reshape(-1) for v in vs])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return [p.to(v.dtype)
            for p, v in zip(buf.split([v.numel() for v in vs]), vs)]


def _count(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.full((1,), float(x.numel() // x.shape[1]),
                      dtype=like.dtype, device=like.device)


class BNTrain(torch.autograd.Function):
    """Train-mode batch norm over (N, H, W) (`bn_train`, norm.py:38-89):
    returns (y, mean, var) with mean and var fp32 [C] (biased variance).
    mean and var feed the running statistics only and take no gradient,
    as in JAX. The elementwise math runs in x's type with autocast off:
    autocast would lift rsqrt to fp32 where flax computes in bf16.
    `group`: the process group whose ranks' rows make the batch (None: x
    alone)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group=None):
        if x.dim() != 4:
            raise ValueError(f"BNTrain: need [N,C,H,W], got {tuple(x.shape)}")
        with torch.autocast(x.device.type, enabled=False):
            x = _dense(x, x)
            n = x.numel() // x.shape[1]
            s, ss = channel_sums(x, x)
            if group is not None:
                s, ss, n = _all_reduce_sums(group, s, ss, _count(x, s))
            mean = s / n
            var = ss / n - mean * mean
            dt = x.dtype
            mul = weight.to(dt) * torch.rsqrt(var.to(dt) + eps)
            y = ((x - _per_channel(mean.to(dt))) * _per_channel(mul)
                 + _per_channel(bias.to(dt)))
            rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            n = ctx.n
            dy = _dense(dy.to(x.dtype), x)
            s_dy, s_dyx = channel_sums(dy, x)
            dbeta = s_dy
            dgamma = rstd * (s_dyx - mean * s_dy)
            if ctx.group is not None:
                # dx from the global sums; dgamma and dbeta stay this
                # rank's share (DDP averages them)
                s_dy, s_dyx = _all_reduce_sums(ctx.group, s_dy, s_dyx)
                g_dgamma = rstd * (s_dyx - mean * s_dy)
            else:
                g_dgamma = dgamma
            # dx = (gamma*rstd) * (dy - dbeta/n - xhat * dgamma/n), folded
            # into a*dy - d*x + b over per-channel fp32 coefficients
            a = weight * rstd
            d = a * rstd * (g_dgamma / n)
            b = -a * (s_dy / n) + d * mean
            dt = x.dtype
            dx = (_per_channel(a.to(dt)) * dy - _per_channel(d.to(dt)) * x
                  + _per_channel(b.to(dt)))
        return dx, dgamma, dbeta, None, None


class SyncBNTrain(torch.autograd.Function):
    """The torch lane's train-mode batch norm over the rows of `group`'s
    ranks together: (y, mean, var) as `BNTrain`'s, from plain
    per-channel sums in fp32 (float64 for float64 inputs), the variance
    and the backward's sum centred on the global mean. y in x's type."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        with torch.autocast(x.device.type, enabled=False):
            acc = torch.promote_types(x.dtype, torch.float32)
            xa = x.to(acc)
            s, n = _all_reduce_sums(group, xa.sum((0, 2, 3)), _count(x, xa))
            mean = s / n
            xc = xa - _per_channel(mean)
            (ss,) = _all_reduce_sums(group, (xc * xc).sum((0, 2, 3)))
            var = ss / n
            rstd = torch.rsqrt(var + eps)
            y = (xc * _per_channel(weight.to(acc) * rstd)
                 + _per_channel(bias.to(acc))).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            acc = mean.dtype
            xhat = (x.to(acc) - _per_channel(mean)) * _per_channel(rstd)
            dy = dy.to(acc)
            s_dy = dy.sum((0, 2, 3))
            s_dyxhat = (dy * xhat).sum((0, 2, 3))
            # this rank's share; DDP averages the ranks' gradients
            dgamma, dbeta = s_dyxhat, s_dy
            s_dy, s_dyxhat = _all_reduce_sums(ctx.group, s_dy, s_dyxhat)
            n = ctx.n
            dx = (_per_channel(weight.to(acc) * rstd)
                  * (dy - _per_channel(s_dy / n)
                     - xhat * _per_channel(s_dyxhat / n))).to(x.dtype)
        return dx, dgamma.to(weight.dtype), dbeta.to(weight.dtype), None, \
            None


class ChannelSumsBatchNorm2d(nn.BatchNorm2d):
    """Counterpart of `TpuBatchNorm` (cartseg_tpu/models/norm.py:92-119):
    train mode through `BNTrain` (the channel-sums kernel on the card),
    flax's running-statistics update with the biased variance (torch's
    momentum 0.1 is flax's 0.9), and eval mode as norm.py:108-112 in the
    input's type. Parameter and buffer names are nn.BatchNorm2d's."""

    recompute = False   # set by `recomputing`
    process_group = None  # set by `sync_batch_norm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            with torch.autocast(x.device.type, enabled=False):
                dt = x.dtype
                mul = self.weight.to(dt) * torch.rsqrt(
                    self.running_var.to(dt) + self.eps)
                return ((x - _per_channel(self.running_mean.to(dt)))
                        * _per_channel(mul) + _per_channel(self.bias.to(dt)))
        y, mean, var = BNTrain.apply(x, self.weight, self.bias, self.eps,
                                     self.process_group)
        if not self.recompute:
            _update_running(self, mean, var)
        return y


def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """flax's running-statistics update with the biased batch variance
    (torch's momentum 0.1 is flax's 0.9)."""
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
        bn.num_batches_tracked.add_(1)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Train model's BatchNorm layers (both lanes) on the statistics of
    the batch that `group`'s ranks hold together (None: each its own
    rows again). Returns model."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, ChannelSumsBatchNorm2d)):
            m.process_group = group
    return model


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
