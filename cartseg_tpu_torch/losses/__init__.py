"""The loss zoo (counterpart of cartseg_tpu/losses): every loss the
reference implements, in PyTorch, with the same public names as the JAX
package's `cartseg_tpu.losses.__all__`.

Where the JAX package has a Pallas kernel (focal, soft-Dice, the
smoothed one-hot, mish/swish/hswish, LSR CE, the EDT under the ABL and
boundary losses), the port's function is an autograd Function or op over
a hand-written CUDA kernel on the card (ops/cuda/) and its plain
PyTorch version on the CPU.
"""

from cartseg_tpu_torch.losses.region import (
    bce_with_logits,
    bce_dice_loss,
    bce_dice_per_sample,
    focal_loss,
    focal_loss_kernel,
    focal_dice_loss,
    soft_dice_loss,
)
from cartseg_tpu_torch.losses.label_smooth import (
    smooth_one_hot,
    lsr_cross_entropy,
    lsr_cross_entropy_fused,
)
from cartseg_tpu_torch.losses.activations import mish, swish, hswish
from cartseg_tpu_torch.losses.taylor_softmax import (
    taylor_softmax,
    log_taylor_softmax,
    taylor_cross_entropy,
)
from cartseg_tpu_torch.losses.ohem import ohem_labels
from cartseg_tpu_torch.losses.lovasz import lovasz_softmax, lovasz_hinge
from cartseg_tpu_torch.losses.large_margin import large_margin_softmax
from cartseg_tpu_torch.losses.layer_norm import layer_norm
from cartseg_tpu_torch.losses.boundary import (
    signed_distance_map,
    symmetric_boundary_loss,
    composite_seg_loss,
)
from cartseg_tpu_torch.losses.abl import active_boundary_loss, bce_dice_abl

__all__ = [
    "bce_with_logits", "bce_dice_loss", "bce_dice_per_sample",
    "focal_loss", "focal_loss_kernel", "focal_dice_loss", "soft_dice_loss",
    "smooth_one_hot", "lsr_cross_entropy", "lsr_cross_entropy_fused",
    "mish", "swish", "hswish",
    "taylor_softmax", "log_taylor_softmax", "taylor_cross_entropy",
    "ohem_labels", "lovasz_softmax", "lovasz_hinge",
    "large_margin_softmax", "layer_norm",
    "signed_distance_map", "symmetric_boundary_loss", "composite_seg_loss",
    "active_boundary_loss", "bce_dice_abl",
]
