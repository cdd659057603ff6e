"""Seeded weights, made on the device in a few large calls.

Every parameter and BatchNorm statistic of a model comes out of one
`torch.randn` over their total size, drawn from a `torch.Generator` on
the device, shaped per leaf by three elementwise passes: convolutions
He-normal, biases 1/sqrt(fan-in), BatchNorm gammas near 1 and betas,
means near 0, variances exp(0.2 z) (so eval-mode statistics are not the
identity). A traffic mix may draw the head's weights `head_gain` times
wider: the pseudo-labeller's members stand for trained models, whose
logits spread over several units, so that the thresholded probabilities
hold confident regions and not a map near one half. The program and
the reference are both handed the result.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cellbench.reference.unet import init_std, param_specs

# (scale, offset) of each leaf kind's normal draw; "var" is exponentiated
_AFFINE = {"gamma": (0.1, 1.0), "beta": (0.1, 0.0), "mean": (0.1, 0.0),
           "var": (0.2, 0.0)}
HEAD = "segmentation_head.0.weight"


def make_weights(encoder: str, count: int, gen: torch.Generator,
                 device, head_gain: float = 1.0
                 ) -> List[Dict[str, torch.Tensor]]:
    """`count` state dicts of the named UNet (float32, on `device`), drawn
    one after the other from `gen`."""
    specs = param_specs(encoder)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    scale, offset, is_var = [], [], []
    for (name, _, (kind, fan)), n in zip(specs, sizes):
        s, o = _AFFINE.get(kind, (init_std(kind, fan), 0.0))
        s *= head_gain if name == HEAD else 1.0
        scale.append(s)
        offset.append(o)
        is_var.append(kind == "var")
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor(scale, device=device),
                                    counts)
    offset = torch.repeat_interleave(torch.tensor(offset, device=device),
                                     counts)
    is_var = torch.repeat_interleave(torch.tensor(is_var, device=device),
                                     counts)
    out = []
    for _ in range(count):
        z = torch.randn(int(counts.sum()), generator=gen, device=device)
        flat = torch.where(is_var, torch.exp(z * scale), z * scale + offset)
        out.append({name: t.view(shape) for (name, shape, _), t in
                    zip(specs, torch.split(flat, sizes))})
    return out


def port_state_dict(params: Dict[str, torch.Tensor]) -> Dict[str,
                                                             torch.Tensor]:
    """The state dict a port model loads: the parameters and statistics,
    and each BatchNorm's `num_batches_tracked`."""
    sd = dict(params)
    for name in params:
        if name.endswith(".running_mean"):
            sd[name[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd
