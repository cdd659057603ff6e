"""Model factory and parameter groups (counterpart of
cartseg_tpu/models/factory.py:27-84): the smp-layout UNet and UNet++
(with or without deep supervision) on the efficientnet-b0, resnet34 and
resnet18 encoders, and the classic UNet; and SAM ViT-B ("sam_vit_b")
for its box-prompted fine-tune."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from cartseg_tpu_torch.models.classic_unet import ClassicUNet
from cartseg_tpu_torch.models.efficientnet import EfficientNetEncoder
from cartseg_tpu_torch.models.resnet import ResNetEncoder
from cartseg_tpu_torch.models.sam import Sam, SamConfig
from cartseg_tpu_torch.models.unet import UNet
from cartseg_tpu_torch.models.unetpp import UNetPlusPlus

_RESNET_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}


def build_model(encoder_name: str = "efficientnet-b0", classes: int = 1,
                bn_lane: str = "torch", decoder: str = "unet", *,
                img_size: int = 1024, dtype=torch.float32) -> nn.Module:
    """The named model (the caller moves it to its device and dtype).
    decoder: "unet", "unetpp" or "unetpp_ds" (UNet++ with deep
    supervision); encoder "classic" is the classic UNet whatever the
    decoder, as in JAX. bn_lane picks every BatchNorm's lane
    (models/norm.py `batch_norm`): "torch" or "channel_sums".
    "sam_vit_b" is SAM ViT-B at its published widths for img_size²
    inputs, computing in `dtype` (the UNets' arguments do not apply),
    its global blocks on the flash-attention lane."""
    if encoder_name == "sam_vit_b":
        return Sam(SamConfig(img_size=img_size, global_attn_flash=True),
                   dtype)
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
    basis of freeze phases and per-group learning rates).

    SAM: the parameters MedSAM's AdamW moves, `image_encoder` as the
    encoder and `mask_decoder` as the decoder. The frozen prompt encoder
    has no group, and neither has the IoU head: the mask loss gives it
    no gradient, so torch's AdamW leaves it as it is. A parameter with
    no group is left out of the update."""
    if isinstance(model, Sam):
        return {n: "encoder" if n.startswith("image_encoder.") else
                "decoder" for n, _ in model.named_parameters()
                if n.startswith(("image_encoder.", "mask_decoder."))
                and not n.startswith("mask_decoder.iou_prediction_head.")}

    def label(name: str) -> str:
        top = name.split(".", 1)[0]
        if top == "encoder":
            return "encoder"
        if top == "segmentation_head" or top.startswith("aux_head"):
            return "head"
        return "decoder"

    return {n: label(n) for n, _ in model.named_parameters()}
