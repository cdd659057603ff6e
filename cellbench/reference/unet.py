"""Plain PyTorch smp.Unet (decoder channels 256/128/64/32/16, nearest 2x
upsampling, a 3x3 head) on the torchvision resnet34 and timm
efficientnet_b0 encoders, written as functions over a flat dict of
tensors in the checkpoint naming those libraries give
(`encoder.conv1.weight`, `encoder.blocks.1.0.conv_pw.weight`,
`decoder.blocks.0.conv1.0.weight`, `segmentation_head.0.bias`).

It is the yardstick that the port's models are held to, so it imports
nothing of the port and computes in float32 with TF32 off (the caller
sets the flags; `fp32_flags`). `quant`, where given, is applied to the
operands of every convolution: the control of the comparison runs the
same functions with operands rounded to fp8.

BatchNorm is written out: eval mode reads the running statistics,
train mode normalises by the batch's biased variance (the running
statistics are not updated; the comparison does not read them).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

DECODER_CHANNELS = (256, 128, 64, 32, 16)
R34_STAGES = (3, 4, 6, 3)
R34_WIDTHS = (64, 128, 256, 512)
# (expand ratio, out channels, repeats, stride, kernel) of efficientnet_b0
B0_BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
             (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
             (6, 320, 1, 1, 3))
# block groups after which smp takes a feature stage
B0_STAGE_ENDS = (1, 2, 4)
ENCODER_CHANNELS = {"resnet34": (64, 64, 128, 256, 512),
                    "efficientnet-b0": (32, 24, 40, 112, 320)}
BN_EPS = {"resnet34": 1e-5, "efficientnet-b0": 1e-3}
DECODER_BN_EPS = 1e-5
SE_RATIO = 0.25

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def fp32_flags():
    """float32 convolutions and matmuls in full float32 for the block."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


# ------------------------------------------------------------ the specs

def _conv_spec(out: List, name: str, cout: int, cin: int, k: int,
               bias: bool = False, fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else cin * k * k
    out.append((name + ".weight", (cout, cin, k, k), ("conv", fan)))
    if bias:
        out.append((name + ".bias", (cout,), ("bias", fan)))


def _bn_spec(out: List, name: str, c: int):
    out.append((name + ".weight", (c,), ("gamma", c)))
    out.append((name + ".bias", (c,), ("beta", c)))
    out.append((name + ".running_mean", (c,), ("mean", c)))
    out.append((name + ".running_var", (c,), ("var", c)))


def _se_channels(in_ch: int) -> int:
    return max(1, int(in_ch * SE_RATIO))


def param_specs(encoder: str) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, (kind, fan-in)) of every parameter and BatchNorm
    statistic, in a fixed order. kind: conv | bias | gamma | beta | mean
    | var."""
    out: List = []
    if encoder == "resnet34":
        _conv_spec(out, "encoder.conv1", 64, 3, 7)
        _bn_spec(out, "encoder.bn1", 64)
        cin = 64
        for li, (n, w) in enumerate(zip(R34_STAGES, R34_WIDTHS)):
            for bi in range(n):
                p = f"encoder.layer{li + 1}.{bi}"
                stride = 2 if (bi == 0 and li > 0) else 1
                _conv_spec(out, p + ".conv1", w, cin, 3)
                _bn_spec(out, p + ".bn1", w)
                _conv_spec(out, p + ".conv2", w, w, 3)
                _bn_spec(out, p + ".bn2", w)
                if stride != 1 or cin != w:
                    _conv_spec(out, p + ".downsample.0", w, cin, 1)
                    _bn_spec(out, p + ".downsample.1", w)
                cin = w
    elif encoder == "efficientnet-b0":
        _conv_spec(out, "encoder.conv_stem", 32, 3, 3)
        _bn_spec(out, "encoder.bn1", 32)
        cin = 32
        for g, (exp, cout, reps, stride, k) in enumerate(B0_BLOCKS):
            for r in range(reps):
                p = f"encoder.blocks.{g}.{r}"
                se = _se_channels(cin)
                if exp == 1:
                    _conv_spec(out, p + ".conv_dw", cin, 1, k, fan_in=k * k)
                    _bn_spec(out, p + ".bn1", cin)
                    _conv_spec(out, p + ".se.conv_reduce", se, cin, 1, True)
                    _conv_spec(out, p + ".se.conv_expand", cin, se, 1, True)
                    _conv_spec(out, p + ".conv_pw", cout, cin, 1)
                    _bn_spec(out, p + ".bn2", cout)
                else:
                    mid = cin * exp
                    _conv_spec(out, p + ".conv_pw", mid, cin, 1)
                    _bn_spec(out, p + ".bn1", mid)
                    _conv_spec(out, p + ".conv_dw", mid, 1, k, fan_in=k * k)
                    _bn_spec(out, p + ".bn2", mid)
                    _conv_spec(out, p + ".se.conv_reduce", se, mid, 1, True)
                    _conv_spec(out, p + ".se.conv_expand", mid, se, 1, True)
                    _conv_spec(out, p + ".conv_pwl", cout, mid, 1)
                    _bn_spec(out, p + ".bn3", cout)
                cin = cout
    else:
        raise ValueError(f"unknown encoder {encoder!r}")
    enc = ENCODER_CHANNELS[encoder]
    skips = list(enc[::-1])[1:] + [0]
    ins = [enc[-1]] + list(DECODER_CHANNELS[:-1])
    for i, (a, s, o) in enumerate(zip(ins, skips, DECODER_CHANNELS)):
        p = f"decoder.blocks.{i}"
        _conv_spec(out, p + ".conv1.0", o, a + s, 3)
        _bn_spec(out, p + ".conv1.1", o)
        _conv_spec(out, p + ".conv2.0", o, o, 3)
        _bn_spec(out, p + ".conv2.1", o)
    _conv_spec(out, "segmentation_head.0", 1, DECODER_CHANNELS[-1], 3, True)
    return out


def trainable(name: str) -> bool:
    return not name.endswith((".running_mean", ".running_var"))


# ----------------------------------------------------------- the forward

class Net:
    """The forward of one UNet over `params`. train: batch statistics in
    every BatchNorm. quant: a function applied to both operands of every
    convolution (None: float32 as they are). remat: each block's
    activations are recomputed in the backward (torch.utils.checkpoint),
    so a float32 step at a card-filling batch fits beside the program.
    quant_grad: applied to every convolution's output, to round the
    gradient that its backward receives."""

    def __init__(self, encoder: str, params: Params, train: bool = False,
                 quant: Optional[Callable] = None, remat: bool = False,
                 quant_grad: Optional[Callable] = None):
        self.encoder, self.P, self.train, self.quant = (encoder, params,
                                                        train, quant)
        self.eps = BN_EPS[encoder]
        self.remat = remat
        self.quant_grad = quant_grad

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def conv(self, name, x, stride=1, pad=0, groups=1):
        w = self.P[name + ".weight"]
        b = self.P.get(name + ".bias")
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = F.conv2d(x, w, b, stride, pad, 1, groups)
        return y if self.quant_grad is None else self.quant_grad(y)

    def bn(self, name, x, eps=None):
        eps = self.eps if eps is None else eps
        if self.train:
            mean = x.mean((0, 2, 3))
            var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
        else:
            mean = self.P[name + ".running_mean"]
            var = self.P[name + ".running_var"]
        scale = self.P[name + ".weight"] * torch.rsqrt(var + eps)
        shift = self.P[name + ".bias"] - mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    # resnet34 ---------------------------------------------------------
    def _r34_stem(self, x):
        return F.relu(self.bn("encoder.bn1",
                              self.conv("encoder.conv1", x, 2, 3)))

    def _r34_block(self, p, stride, down, y):
        h = F.relu(self.bn(p + ".bn1", self.conv(p + ".conv1", y, stride, 1)))
        h = self.bn(p + ".bn2", self.conv(p + ".conv2", h, 1, 1))
        r = self.bn(p + ".downsample.1",
                    self.conv(p + ".downsample.0", y, stride)) if down else y
        return F.relu(h + r)

    def _r34(self, x):
        y = self._run(self._r34_stem, x)
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        cin = 64
        for li, (n, w) in enumerate(zip(R34_STAGES, R34_WIDTHS)):
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                y = self._run(functools.partial(
                    self._r34_block, f"encoder.layer{li + 1}.{bi}", stride,
                    stride != 1 or cin != w), y)
                cin = w
            feats.append(y)
        return feats

    # efficientnet-b0 --------------------------------------------------
    def _se(self, p, y):
        s = y.mean((2, 3), keepdim=True)
        s = self.conv(p + ".se.conv_expand",
                      F.silu(self.conv(p + ".se.conv_reduce", s)))
        return y * torch.sigmoid(s)

    def _b0_stem(self, x):
        return F.silu(self.bn("encoder.bn1",
                              self.conv("encoder.conv_stem", x, 2, 1)))

    def _b0_block(self, p, exp, cin, cout, s, k, y):
        if exp == 1:
            h = F.silu(self.bn(p + ".bn1", self.conv(
                p + ".conv_dw", y, s, k // 2, groups=cin)))
            h = self.bn(p + ".bn2", self.conv(p + ".conv_pw", self._se(p, h)))
        else:
            mid = cin * exp
            h = F.silu(self.bn(p + ".bn1", self.conv(p + ".conv_pw", y)))
            h = F.silu(self.bn(p + ".bn2", self.conv(
                p + ".conv_dw", h, s, k // 2, groups=mid)))
            h = self.bn(p + ".bn3", self.conv(p + ".conv_pwl",
                                               self._se(p, h)))
        return h + y if (s == 1 and cin == cout) else h

    def _b0(self, x):
        y = self._run(self._b0_stem, x)
        feats = [y]
        cin = 32
        for g, (exp, cout, reps, stride, k) in enumerate(B0_BLOCKS):
            for r in range(reps):
                y = self._run(functools.partial(
                    self._b0_block, f"encoder.blocks.{g}.{r}", exp, cin,
                    cout, stride if r == 0 else 1, k), y)
                cin = cout
            if g in B0_STAGE_ENDS:
                feats.append(y)
        feats.append(y)
        return feats

    def decoder_block(self, i, y, skip):
        p = f"decoder.blocks.{i}"
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip], 1)
        y = F.relu(self.bn(p + ".conv1.1", self.conv(p + ".conv1.0", y, 1, 1),
                           DECODER_BN_EPS))
        return F.relu(self.bn(p + ".conv2.1",
                              self.conv(p + ".conv2.0", y, 1, 1),
                              DECODER_BN_EPS))

    def encode(self, x):
        return self._r34(x) if self.encoder == "resnet34" else self._b0(x)

    def decode(self, feats):
        head, *skips = feats[::-1]
        y = head
        for i in range(len(DECODER_CHANNELS)):
            if i < len(skips):
                y = self._run(functools.partial(self.decoder_block, i), y,
                              skips[i])
            else:
                y = self._run(functools.partial(self.decoder_block, i,
                                                skip=None), y)
        return self._run(functools.partial(self.conv, "segmentation_head.0",
                                           stride=1, pad=1), y)

    def __call__(self, x):
        """NCHW float32 input -> NCHW float32 logits [B,1,H,W]."""
        return self.decode(self.encode(x))


# ---------------------------------------------------------- fp8 control

def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """t through the fp8 `dtype` under one per-tensor scale that maps its
    largest magnitude onto `top`, the format's largest finite value."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude onto 448), back in t's dtype; gradients pass straight
    through, so a backward runs on the rounded operands."""
    return t + (_fp8(t.detach(), torch.float8_e4m3fn, 448.0) - t).detach()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, back in t's dtype (the yardstick of the
    configurations' precision); gradients pass straight through."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


def fp8_grad_round(t: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient that comes back is rounded to float8
    e5m2 under one per-tensor scale (fp8 training's gradient format)."""
    return _Fp8Grad.apply(t)


def init_std(kind: str, fan: int) -> float:
    """The spread of a seeded parameter (He-normal for convolutions)."""
    if kind == "conv":
        return math.sqrt(2.0 / fan)
    if kind == "bias":
        return 1.0 / math.sqrt(fan)
    return 0.0
