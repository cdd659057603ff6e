"""LR schedules and phase controllers (counterpart of
cartseg_tpu/train/schedules.py, which holds no JAX and is copied as it
is).

The reference steps torch CosineAnnealingLR once per epoch with
T_max=EPOCHS (train_bce_dice.py:311,381) and switches param-group LRs
at the freeze->unfreeze boundary (train_with_pretrained.py:361-374).
The host computes the per-epoch, per-group LRs and hands them to the
optimizer step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def cosine_epoch_lr(base_lr: float, epoch: int, total_epochs: int,
                    eta_min: float = 0.0) -> float:
    """torch.optim.lr_scheduler.CosineAnnealingLR value AT `epoch`
    (0-based; epoch 0 = base lr)."""
    if total_epochs <= 0:
        return base_lr
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / total_epochs)) / 2


@dataclasses.dataclass
class FreezePhase:
    """Encoder freeze->unfreeze controller, generalizing
    EncoderWarmupController (src/finetune_pseudo.py:107-125) and the
    two-phase LR switch (src/train_with_pretrained.py:335-372).

    While epoch < freeze_epochs the encoder LR is 0 (and, like torch
    with requires_grad=False, its Adam moments receive zero gradients,
    so they stay at init). At the boundary the encoder trains at
    base_lr * unfreeze_scale.
    """

    freeze_epochs: int = 0
    unfreeze_scale: float = 1.0

    def encoder_on(self, epoch: int) -> bool:
        return epoch >= self.freeze_epochs

    def lr_scales(self, epoch: int, encoder_scale: float,
                  head_scale: float) -> Tuple[float, float, float]:
        """(encoder, decoder, head) multipliers for this epoch."""
        enc = 0.0 if epoch < self.freeze_epochs \
            else encoder_scale * self.unfreeze_scale
        return enc, 1.0, head_scale
