"""Focal-Dice, never frozen (counterpart of
cartseg_tpu/workloads/train_with_focal_dice_unfrozen.py; reference
src/train_with_focalDice_unfrozen.py): three learning-rate tiers from
the first epoch, the encoder at 0.1x, the decoder at 1x and the head at
3x the learning rate (:389-391), each logged in the `prf1` CSV
(lr_encoder, lr_decoder, lr_head).

Usage:
  python -m cartseg_tpu_torch.workloads.train_with_focal_dice_unfrozen \\
      --images_root DIR --masks_root DIR [--out_dir DIR] [--epochs N] \\
      [--device cuda]
Any TrainConfig field is a flag (`--field value`). The default device
is cuda; a machine without a card raises unless `--device cpu` is
given.
"""

from cartseg_tpu_torch.train import LossSpec, TrainConfig
from cartseg_tpu_torch.workloads._runner import run

CONFIG = TrainConfig(
    encoder="efficientnet-b0",
    img_size=(512, 512),
    imagenet_norm=True,
    batch_size=6,
    epochs=50,
    lr=1e-4,
    weight_decay=1e-4,
    patience=8,
    loss=LossSpec("focal_dice",
                  {"alpha": 0.5, "gamma": 2.0, "w_focal": 0.7}),
    augment="train_512",
    freeze_encoder_epochs=0,
    encoder_lr_scale=0.1,
    head_lr_scale=3.0,
    metrics_schema="prf1",
    out_dir="runs/train_with_focal_dice_unfrozen",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
