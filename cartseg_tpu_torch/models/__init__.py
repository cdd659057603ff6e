"""Models: the efficientnet-b0 UNet in smp layout and the JAX bridge."""

from cartseg_tpu_torch.models.factory import build_model, param_groups  # noqa: F401
