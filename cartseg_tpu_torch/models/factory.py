"""Model factory and parameter groups (counterpart of
cartseg_tpu/models/factory.py:27-84)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from cartseg_tpu_torch.models.efficientnet import EfficientNetEncoder
from cartseg_tpu_torch.models.unet import UNet


def build_model(encoder_name: str = "efficientnet-b0",
                classes: int = 1) -> nn.Module:
    """smp-layout UNet with the named encoder, in eval mode's layout
    (the caller moves it to its device and dtype)."""
    if encoder_name == "efficientnet-b0":
        return UNet(EfficientNetEncoder(), classes=classes)
    if encoder_name in ("resnet34", "resnet18", "classic"):
        raise NotImplementedError(
            f"encoder {encoder_name!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 2: models); only efficientnet-b0 is")
    raise ValueError(f"unknown encoder {encoder_name!r}")


def param_groups(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'encoder' | 'decoder' | 'head', by the top-level
    module, as the JAX `param_groups` labels its param subtrees (the
    basis of freeze phases and per-group learning rates)."""
    def label(name: str) -> str:
        top = name.split(".", 1)[0]
        if top == "encoder":
            return "encoder"
        if top == "segmentation_head" or top.startswith("aux_head"):
            return "head"
        return "decoder"

    return {n: label(n) for n, _ in model.named_parameters()}
