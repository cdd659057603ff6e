"""UNet++ (Zhou et al., arXiv:1912.05074) with optional deep supervision
(counterpart of cartseg_tpu/models/unetpp.py): nested dense skips,
X[i][j] = ConvBlock(concat(X[i][0..j-1], up2(X[i+1][j-1]))), channels
(16, 32, 64, 128, 256) at levels 0..4 whatever the encoder, then a
`final` block brings X[0][4] (stride 2) to the input resolution.

Each node's first conv sees its inputs in the JAX order, the node's own
row first and the upsampled node below last (unetpp.py:43-49); the
weight bridge (models/convert.py) depends on it. Module names follow the
JAX tree (`decoder.x_{i}_{j}.{conv1,bn1,conv2,bn2}`, `decoder.final`,
`segmentation_head.0`, `aux_head_{j}.0`), and every BatchNorm comes from
models/norm.py's `batch_norm` in the caller's lane.

Only the plain decoder lane is ported: the JAX fused lane
(`FusedUpsampleConv`, CARTSEG_FUSED_DECODER) holds the same parameters
and computes the same function (ROADMAP.md Queue 1 item 1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.models.norm import batch_norm

CHANNELS = (16, 32, 64, 128, 256)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x (the JAX `_upsample2x`: each pixel repeated
    into a 2x2 block)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConvBlock(nn.Module):
    """(conv 3x3, no bias, BN, ReLU) x 2. The first conv reads
    concat([*parts, up2(up)]) on the channel axis."""

    def __init__(self, cin: int, cout: int, bn_lane: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn1 = batch_norm(cout, 1e-5, bn_lane)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(cout, 1e-5, bn_lane)

    def forward(self, parts: List[torch.Tensor], up: torch.Tensor):
        x = torch.cat(parts + [upsample2x(up)], 1)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UNetPlusPlusDecoder(nn.Module):
    """Encoder features [c1 (stride 2) .. c5 (stride 32)] -> the full-
    resolution map, and the top-row nodes X[0][1..3] for the deep-
    supervision heads."""

    def __init__(self, enc_channels: Sequence[int],
                 channels: Sequence[int] = CHANNELS, bn_lane: str = "torch"):
        super().__init__()
        L = len(enc_channels)
        self.levels = L
        ch = {(i, 0): enc_channels[i] for i in range(L)}
        for j in range(1, L):
            for i in range(L - j):
                cin = sum(ch[(i, k)] for k in range(j)) + ch[(i + 1, j - 1)]
                self.add_module(f"x_{i}_{j}",
                                ConvBlock(cin, channels[i], bn_lane))
                ch[(i, j)] = channels[i]
        self.final = ConvBlock(ch[(0, L - 1)], channels[0], bn_lane)

    def forward(self, feats):
        L = self.levels
        grid = {(i, 0): feats[i] for i in range(L)}
        for j in range(1, L):
            for i in range(L - j):
                grid[(i, j)] = getattr(self, f"x_{i}_{j}")(
                    [grid[(i, k)] for k in range(j)], grid[(i + 1, j - 1)])
        y = self.final([], grid[(0, L - 1)])
        return y, [grid[(0, j)] for j in range(1, L - 1)]


def _head(cin: int, classes: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, classes, 3, 1, 1))


class UNetPlusPlus(nn.Module):
    """encoder + UNet++ decoder + head; NCHW in, NCHW logits out.
    deep_supervision: the logits are the mean of the final head and a
    head on each upsampled X[0][j], j = 1..3 (the paper's accurate mode),
    each head's output in float32 as JAX's SegmentationHead returns it."""

    def __init__(self, encoder: nn.Module, classes: int = 1,
                 deep_supervision: bool = False, bn_lane: str = "torch"):
        super().__init__()
        self.encoder = encoder
        self.decoder = UNetPlusPlusDecoder(encoder.out_channels,
                                           bn_lane=bn_lane)
        self.segmentation_head = _head(CHANNELS[0], classes)
        self.aux_heads = [f"aux_head_{j}" for j in range(
            1, self.decoder.levels - 1)] if deep_supervision else []
        for name in self.aux_heads:
            self.add_module(name, _head(CHANNELS[0], classes))

    def forward(self, x):
        y, nodes = self.decoder(self.encoder(x))
        logits = self.segmentation_head(y).float()
        if not self.aux_heads:
            return logits
        for name, node in zip(self.aux_heads, nodes):
            logits = logits + getattr(self, name)(upsample2x(node)).float()
        return logits / (1.0 + len(nodes))
