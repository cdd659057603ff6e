"""Focal-Dice training (counterpart of
cartseg_tpu/workloads/train_with_focal_dice.py; reference
src/train_with_focalDice.py): FocalDice(alpha=0.5, gamma=2,
w_focal=0.7) (:381), the encoder frozen for 8 epochs and then trained at
0.3 of the learning rate (:407-420), efficientnet-b0 UNet, ImageNet
normalisation, `prf1` CSV.

Usage:
  python -m cartseg_tpu_torch.workloads.train_with_focal_dice \\
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
    freeze_encoder_epochs=8,
    unfreeze_encoder_lr_scale=0.3,
    metrics_schema="prf1",
    out_dir="runs/train_with_focal_dice",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
