"""Models: the efficientnet-b0 and resnet34/18 UNets in smp layout, UNet++
with or without deep supervision on the same encoders, the classic UNet,
both BatchNorm lanes, and the JAX bridge."""

from cartseg_tpu_torch.models.factory import build_model, param_groups  # noqa: F401
