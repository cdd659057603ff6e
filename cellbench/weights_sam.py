"""Seeded SAM weights, made on the device in a few large calls (the
recipe of weights.py): every parameter and buffer of the model comes out
of one `torch.randn` over their total size, drawn from a
`torch.Generator` on the device and shaped per leaf by elementwise
passes. Linears and convolutions are N(0, 1/fan-in) (with N(0, 1)
matrices the decoder's logits are ill-conditioned), biases N(0,
1/fan-in), LayerNorm weights near 1 and biases near 0 (at 1 / 0 the
neck's last LayerNorm makes the embedding's scale fixed, and gradients
through it rounding noise), the rel-pos tables and the position
embedding non-zero (the official init leaves both at 0, which would take
the flash kernels' bias and its gradient off the path), the embeddings
and the prompt encoder's Fourier matrix N(0, 1) as torch initialises
them. The program and the reference are both handed the result.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cellbench.reference.sam import Sizes, param_specs

# (scale, offset) of each leaf kind's normal draw; the matrices' scale
# is 1/sqrt(fan-in)
_AFFINE = {"gamma": (0.1, 1.0), "beta": (0.1, 0.0), "embed": (1.0, 0.0),
           "gauss": (1.0, 0.0), "pos": (0.1, 0.0), "rel_pos": (0.1, 0.0)}


def make_weights(s: Sizes, gen: torch.Generator, device
                 ) -> Dict[str, torch.Tensor]:
    """The state dict of one SAM (float32, on `device`) drawn from gen."""
    specs = param_specs(s)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    scale, offset = [], []
    for _, _, (kind, fan) in specs:
        sc, off = _AFFINE.get(kind, (1.0 / math.sqrt(fan), 0.0))
        scale.append(sc)
        offset.append(off)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor(scale, device=device),
                                    counts)
    offset = torch.repeat_interleave(torch.tensor(offset, device=device),
                                     counts)
    z = torch.randn(int(counts.sum()), generator=gen, device=device)
    flat = z * scale + offset
    return {name: t.view(shape) for (name, shape, _), t in
            zip(specs, torch.split(flat, sizes))}
