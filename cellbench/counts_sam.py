"""The SAM fine-tune step's arithmetic for its yardsticks: FLOPs of a
step counted on the plain reference (reference/sam.py) by
`torch.utils.flop_counter.FlopCounterMode` on the `meta` device, so they
do not depend on how the program computes them (products and
convolutions; elementwise work is not counted), and the global
attention's own arithmetic, which the flash kernels' roofline is read
against."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from cellbench.reference import sam as ref
from cellbench.reference import train as ref_train


def step_flops(s: ref.Sizes, batch: int) -> int:
    """FLOPs of one fine-tune step's forward and backward (autograd's
    gradients of the trained parameters: no gradient of the frames, none
    recomputed) over `batch` frames of s.img_size²."""
    dev = torch.device("meta")
    params = {name: torch.empty(shape, device=dev,
                                requires_grad=ref.trained(name))
              for name, shape, _ in ref.param_specs(s)}
    leaves = [p for p in params.values() if p.requires_grad]
    size = s.img_size
    x = torch.empty((batch, size, size, 3), device=dev)
    boxes = torch.empty((batch, 4), device=dev)
    y = torch.empty((batch, size, size, 1), device=dev)
    with FlopCounterMode(display=False) as counter:
        logits = ref.Model(s, params)(x, boxes)
        loss = ref_train.bce_dice(logits.permute(0, 2, 3, 1), y, 0.5, 1.0)
        torch.autograd.grad(loss, leaves)
    return int(counter.get_total_flops())


def attention_flops(s: ref.Sizes, batch: int) -> int:
    """The global blocks' attention arithmetic in one step: per block,
    4 bnh S^2 d in the forward (Q K^T and P V) and 8 bnh S^2 d in the
    backward (dP, dS's products dQ and dK, and dV), bnh = batch x heads,
    S = grid^2 tokens, d the head size. What the kernels recompute is
    not credited."""
    bnh = batch * s.encoder_heads
    seq = s.grid ** 2
    d = s.encoder_dim // s.encoder_heads
    return 12 * bnh * seq * seq * d * len(s.global_attn_indexes)
