"""Euclidean distance transform by jump flooding (counterpart of
cartseg_tpu/ops/edt.py).

1+JFA: log2(N)+2 steps of 8 shift-compare candidates, exact on the
overwhelming majority of pixels, with rare small errors well inside the
20 px clamp the losses apply. The port computes the JAX XLA lane's
function bit for bit: the CUDA kernel on the card, the plain version on
the CPU (ops/cuda/edt.py). The JAX `return_indices` option has no caller
on this slice and is not ported.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa


def edt(seeds: torch.Tensor) -> torch.Tensor:
    """Distance from every pixel to the nearest True pixel of `seeds`
    ([H,W] bool), float32; sqrt(1e12) = 1e6 everywhere when there is no
    seed (callers guard with `seeds.any()`)."""
    return edt_batch(seeds[None])[0]


def edt_batch(seeds: torch.Tensor) -> torch.Tensor:
    """[B,H,W] seeds -> [B,H,W] float32 distances (the JAX `edt_batch`,
    whose TPU lane is the Pallas flood and whose other lane is the
    vmapped XLA JFA; both compute this function)."""
    return edt_batch_jfa(seeds.to(torch.bool).contiguous())


def distance_transform_edt(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.distance_transform_edt semantics on [H,W]: for each
    nonzero pixel, the distance to the nearest zero pixel; 0 on zeros,
    and 0 everywhere when the mask has no zero."""
    mask = mask.to(torch.bool)
    d = torch.where(mask, edt(~mask), 0.0)
    return torch.where((~mask).any(), d, 0.0)
