"""The yardstick's arithmetic: the chip's published peaks, the FLOPs of a
model's work counted on the plain reference, and the bytes a kernel's
inputs and outputs take, read once and written once.

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over the
reference UNet's forward on the `meta` device at the cell's shapes, so
they do not depend on how the program computes them (convolutions and
matrix products; elementwise work is not counted). A training step adds
the backward's two products a convolution, each as many FLOPs as its
forward, less the input gradient of the first convolution, which no
one needs: FlopCounterMode's own count of a grouped convolution's
backward is the group count times too high (98x for a depthwise 3x3 of
96 channels), so the backward is not counted by it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from cellbench.reference.unet import Net, param_specs

# each encoder's first convolution: (weight name, stride, padding)
_STEM = {"resnet34": ("encoder.conv1.weight", 2, 3),
         "efficientnet-b0": ("encoder.conv_stem.weight", 2, 1)}

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named `kind`
    (torch.cuda.get_device_name()), or None for a card not in the table."""
    return json.loads(PEAKS.read_text()).get(kind)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def unet_flops(encoder: str, batch: int, size: int, backward: bool) -> int:
    """FLOPs of the reference UNet's forward (and backward) over a batch
    of `batch` frames of size x size."""
    dev = torch.device("meta")
    params = {name: torch.empty(shape, device=dev)
              for name, shape, _ in param_specs(encoder)}
    x = torch.empty((batch, 3, size, size), device=dev)
    forward = _count(lambda: Net(encoder, params, train=backward)(x))
    if not backward:
        return forward
    name, stride, pad = _STEM[encoder]
    stem = _count(lambda: torch.nn.functional.conv2d(
        x, params[name], None, stride, pad))
    return 3 * forward - stem


def cc_bytes(batch: int, h: int, w: int) -> int:
    """Connected-component labelling: bool [B,H,W] in, int32 labels out."""
    return batch * h * w * (1 + 4)


def median_bytes(rows: int, n: int) -> int:
    """Row medians: float32 [rows, n] in, float32 [rows] out."""
    return rows * n * 4 + rows * 4


def lsr_fwd_bytes(n: int, c: int, label_bytes: int) -> int:
    """Label-smoothed CE forward: float32 [n, C] logits and [n] labels in,
    float32 [n] losses out."""
    return n * c * 4 + n * label_bytes + n * 4


def lsr_bwd_bytes(n: int, c: int, label_bytes: int) -> int:
    """Its backward: logits, labels and the [n] incoming gradient in, the
    float32 [n, C] gradient out."""
    return n * c * 4 + n * label_bytes + n * 4 + n * c * 4
