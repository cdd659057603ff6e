"""Model factory and parameter groups (counterpart of
cartseg_tpu/models/factory.py:27-84)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from cartseg_tpu_torch.models.efficientnet import EfficientNetEncoder
from cartseg_tpu_torch.models.resnet import ResNetEncoder
from cartseg_tpu_torch.models.unet import UNet

_RESNET_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}


def build_model(encoder_name: str = "efficientnet-b0", classes: int = 1,
                bn_lane: str = "torch") -> nn.Module:
    """smp-layout UNet with the named encoder (the caller moves it to its
    device and dtype). bn_lane picks every BatchNorm's lane
    (models/norm.py `batch_norm`): "torch" or "channel_sums"."""
    if encoder_name == "efficientnet-b0":
        enc = EfficientNetEncoder(bn_lane)
    elif encoder_name in _RESNET_STAGES:
        enc = ResNetEncoder(_RESNET_STAGES[encoder_name], bn_lane)
    elif encoder_name == "classic":
        raise NotImplementedError(
            "encoder 'classic' (models/classic_unet.py) is not ported yet "
            "(ROADMAP.md Queue 1 item 8: other model families)")
    else:
        raise ValueError(f"unknown encoder {encoder_name!r}")
    return UNet(enc, classes=classes, bn_lane=bn_lane)


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
