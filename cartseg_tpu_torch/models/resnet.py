"""ResNet-18/34 encoder (counterpart of cartseg_tpu/models/resnet.py).

Basic blocks; stage_sizes (3,4,6,3) is resnet34, (2,2,2,2) resnet18.
Returns the 5 smp feature stages at strides 2/4/8/16/32 with channels
64/64/128/256/512: the stem (7x7/2 conv, BN, ReLU) before its 3x3/2/1
max-pool, then each layer. Module and parameter names follow
torchvision (conv1, bn1, layer{1..4}.{i}.conv1/bn1/conv2/bn2/
downsample.{0,1}), which is what the reference checkpoints hold
(train_bce_dice.py:293-301; benchmarks/torch_smp.py:33-95), so a
reference `.pth` loads with plain `load_state_dict`. BN eps 1e-5, from
the `batch_norm` factory in the caller's lane. The JAX `StashConv`
(fp8 residual stash, off by default) is a plain convolution here.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.models.norm import batch_norm

BN_EPS = 1e-5
WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, bn_lane: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(cout, BN_EPS, bn_lane)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(cout, BN_EPS, bn_lane)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, 0, bias=False),
                batch_norm(cout, BN_EPS, bn_lane))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNetEncoder(nn.Module):
    out_channels = (64,) + WIDTHS

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bn_lane: str = "torch"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64, BN_EPS, bn_lane)
        cin = 64
        for li, (n_blocks, w) in enumerate(zip(stage_sizes, WIDTHS)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                blocks.append(BasicBlock(cin, w, stride, bn_lane))
                cin = w
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        """NCHW input -> list of the 5 stage feature maps."""
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]                                   # stride 2, 64ch
        y = F.max_pool2d(y, 3, 2, 1)
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
            feats.append(y)                           # strides 4..32
        return feats
