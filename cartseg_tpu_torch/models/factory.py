"""Model factory and parameter groups (counterpart of
cartseg_tpu/models/factory.py:27-84): the smp-layout UNet and UNet++
(with or without deep supervision) on the efficientnet-b0, resnet34 and
resnet18 encoders, and the classic UNet."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from cartseg_tpu_torch.models.classic_unet import ClassicUNet
from cartseg_tpu_torch.models.efficientnet import EfficientNetEncoder
from cartseg_tpu_torch.models.resnet import ResNetEncoder
from cartseg_tpu_torch.models.unet import UNet
from cartseg_tpu_torch.models.unetpp import UNetPlusPlus

_RESNET_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}


def build_model(encoder_name: str = "efficientnet-b0", classes: int = 1,
                bn_lane: str = "torch", decoder: str = "unet") -> nn.Module:
    """The named model (the caller moves it to its device and dtype).
    decoder: "unet", "unetpp" or "unetpp_ds" (UNet++ with deep
    supervision); encoder "classic" is the classic UNet whatever the
    decoder, as in JAX. bn_lane picks every BatchNorm's lane
    (models/norm.py `batch_norm`): "torch" or "channel_sums"."""
    if encoder_name == "efficientnet-b0":
        enc = EfficientNetEncoder(bn_lane)
    elif encoder_name in _RESNET_STAGES:
        enc = ResNetEncoder(_RESNET_STAGES[encoder_name], bn_lane)
    elif encoder_name == "classic":
        return ClassicUNet(out_channels=classes)
    else:
        raise ValueError(f"unknown encoder {encoder_name!r}")
    if decoder in ("unetpp", "unetpp_ds"):
        return UNetPlusPlus(enc, classes, decoder == "unetpp_ds", bn_lane)
    if decoder != "unet":
        raise ValueError(f"unknown decoder {decoder!r}")
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
