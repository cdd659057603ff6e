"""UNet decoder and segmentation head (counterpart of
cartseg_tpu/models/unet.py): smp.Unet's decoder_channels
(256,128,64,32,16), nearest-2x upsample, concat with the skip, then
conv-BN-ReLU twice (BN from models/norm.py's `batch_norm` factory in
the caller's lane, eps 1e-5), and a 3x3 head conv. smp naming
(decoder.blocks.{i}.conv{1,2}.{0,1}, segmentation_head.0), so reference
checkpoints load as they are.

Only the plain decoder lane is ported. The JAX package's
`FusedUpsampleConv` (unet.py:80-156) holds the same parameters and
computes the same function as a transposed convolution; it exists for
TPU memory traffic and has no role here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.models.norm import batch_norm


def _conv_bn_relu(cin: int, cout: int, bn_lane: str) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1, bias=False),
                         batch_norm(cout, 1e-5, bn_lane),
                         nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, bn_lane: str):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin, cout, bn_lane)
        self.conv2 = _conv_bn_relu(cout, cout, bn_lane)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], 1)
        return self.conv2(self.conv1(x))


class UNetDecoder(nn.Module):
    def __init__(self, enc_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 bn_lane: str = "torch"):
        super().__init__()
        # skips are the encoder stages reversed minus the deepest; the
        # last block (input resolution) has none
        skips = list(enc_channels[::-1])[1:] + [0]
        ins = [enc_channels[-1]] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(i + s, o, bn_lane)
            for i, s, o in zip(ins, skips, decoder_channels))

    def forward(self, feats):
        head, *skips = feats[::-1]
        y = head
        for i, block in enumerate(self.blocks):
            y = block(y, skips[i] if i < len(skips) else None)
        return y


class UNet(nn.Module):
    """encoder + decoder + head; NCHW in, NCHW logits out
    (activation=None, as in every reference build_model)."""

    def __init__(self, encoder: nn.Module, classes: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 bn_lane: str = "torch"):
        super().__init__()
        self.encoder = encoder
        self.decoder = UNetDecoder(encoder.out_channels, decoder_channels,
                                   bn_lane)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], classes, 3, 1, 1))

    def forward(self, x):
        return self.segmentation_head(self.decoder(self.encoder(x)))
