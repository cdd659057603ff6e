"""BCE+Dice + Active Boundary Loss (counterpart of
cartseg_tpu/workloads/train_bce_dice_abl.py; reference
src/training/train_BCEDice_ABL.py): abl_weight=0.1, boundary-skip-rate
tracking, loss components in the history. The ABL runs on the device:
the jump-flood EDT and the label-smoothed CE are CUDA kernels on the
card.

Usage:
  python -m cartseg_tpu_torch.workloads.train_bce_dice_abl \
      --images_root DIR --masks_root DIR [--out_dir DIR] [--epochs N] \
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
    epochs=40,
    lr=1e-4,
    weight_decay=1e-4,
    patience=8,
    seed=1337,
    loss=LossSpec("bce_dice_abl", {"bce_weight": 0.5, "abl_weight": 0.1}),
    augment="train_512",
    split="session_seeded",
    metrics_schema="abl",
    out_dir="runs/train_bce_dice_abl",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
