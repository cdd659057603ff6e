"""The classic UNet of the annotation tools' proposal model (counterpart
of cartseg_tpu/models/classic_unet.py; reference src/create_testset.py:
40-83): DoubleConv (3x3 convs with bias, no norm, ReLU) at widths
base x (1, 2, 4, 8), a 16 x base bottleneck, a ConvTranspose 2x2
stride-2 decoder that concatenates [skip, up], a 1x1 head, and a
sigmoid: this model returns PROBABILITIES, where the smp models return
logits.

State-dict names are the ones the JAX importer reads
(cartseg_tpu/models/torch_import.py `import_classic_unet`):
`downs.{i}.conv{1,2}`, `bottleneck.conv{1,2}`, `ups.{i}`,
`updcs.{i}.conv{1,2}`, `head`, so a reference checkpoint loads with
`load_state_dict` alone.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class ClassicUNet(nn.Module):
    """NCHW in, NCHW float32 probabilities out."""

    def __init__(self, out_channels: int = 1, base: int = 64,
                 in_channels: int = 3):
        super().__init__()
        widths = [base * m for m in (1, 2, 4, 8)]
        self.downs = nn.ModuleList(
            DoubleConv(c, w) for c, w in zip([in_channels] + widths[:-1],
                                             widths))
        self.bottleneck = DoubleConv(widths[-1], base * 16)
        self.ups = nn.ModuleList(nn.ConvTranspose2d(2 * w, w, 2, 2)
                                 for w in reversed(widths))
        self.updcs = nn.ModuleList(DoubleConv(2 * w, w)
                                   for w in reversed(widths))
        self.head = nn.Conv2d(base, out_channels, 1)

    def forward(self, x):
        skips = []
        for down in self.downs:
            x = down(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for up, dc, skip in zip(self.ups, self.updcs, reversed(skips)):
            x = up(x)
            x = dc(torch.cat([skip, x], 1))
        return torch.sigmoid(self.head(x).float())
