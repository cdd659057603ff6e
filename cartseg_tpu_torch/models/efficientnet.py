"""EfficientNet-B0 encoder (counterpart of cartseg_tpu/models/efficientnet.py).

Standard B0 (MBConv with squeeze-excite, SiLU, BN eps 1e-3) returning
the 5 smp feature stages at strides 2/4/8/16/32 with channels
32/24/40/112/320. Module and parameter names follow timm's
`efficientnet_b0` (conv_stem, bn1, blocks.{g}.{r}.conv_pw/conv_dw/
se.conv_reduce/se.conv_expand/conv_pwl/bn1..bn3), which is what the
reference checkpoints hold (src/train_with_pretrained.py:317-325), so a
reference `.pth` loads with plain `load_state_dict`. BN comes from
models/norm.py's `batch_norm` factory in the caller's lane (flax's
running-variance update in both).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.models.norm import batch_norm

# (expand_ratio, out_channels, num_repeats, stride, kernel_size)
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# block groups after which smp cuts an encoder stage; the final 320ch
# stage is appended after the loop
_STAGE_ENDS = (1, 2, 4)
BN_EPS = 1e-3


class SqueezeExcite(nn.Module):
    """SE on the block's INPUT channel count (timm convention)."""

    def __init__(self, ch: int, in_ch: int, ratio: float = 0.25):
        super().__init__()
        se_ch = max(1, int(in_ch * ratio))
        self.conv_reduce = nn.Conv2d(ch, se_ch, 1)
        self.conv_expand = nn.Conv2d(se_ch, ch, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DepthwiseSeparableConv(nn.Module):
    """The expand==1 MBConv (timm DepthwiseSeparableConv naming)."""

    def __init__(self, cin: int, cout: int, stride: int, k: int,
                 bn_lane: str):
        super().__init__()
        self.conv_dw = nn.Conv2d(cin, cin, k, stride, k // 2, groups=cin,
                                 bias=False)
        self.bn1 = batch_norm(cin, BN_EPS, bn_lane)
        self.se = SqueezeExcite(cin, cin)
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = batch_norm(cout, BN_EPS, bn_lane)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(self.se(y)))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """The expand>1 MBConv (timm InvertedResidual naming)."""

    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 k: int, bn_lane: str):
        super().__init__()
        mid = cin * expand
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = batch_norm(mid, BN_EPS, bn_lane)
        self.conv_dw = nn.Conv2d(mid, mid, k, stride, k // 2, groups=mid,
                                 bias=False)
        self.bn2 = batch_norm(mid, BN_EPS, bn_lane)
        self.se = SqueezeExcite(mid, cin)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = batch_norm(cout, BN_EPS, bn_lane)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.has_skip else y


class EfficientNetEncoder(nn.Module):
    out_channels = (32, 24, 40, 112, 320)

    def __init__(self, bn_lane: str = "torch"):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = batch_norm(32, BN_EPS, bn_lane)
        groups = []
        cin = 32
        for exp, cout, reps, stride, k in B0_BLOCKS:
            blocks = []
            for r in range(reps):
                s = stride if r == 0 else 1
                if exp == 1:
                    blocks.append(DepthwiseSeparableConv(cin, cout, s, k,
                                                         bn_lane))
                else:
                    blocks.append(InvertedResidual(cin, cout, exp, s, k,
                                                   bn_lane))
                cin = cout
            groups.append(nn.Sequential(*blocks))
        self.blocks = nn.ModuleList(groups)

    def forward(self, x):
        """NCHW input -> list of the 5 stage feature maps."""
        feats = []
        y = F.silu(self.bn1(self.conv_stem(x)))
        feats.append(y)                        # stride 2, 32ch
        for gi, group in enumerate(self.blocks):
            y = group(y)
            if gi in _STAGE_ENDS:
                feats.append(y)                # strides 4, 8, 16
        feats.append(y)                        # stride 32, 320ch
        return feats
