"""Baseline BCE+Dice training (counterpart of
cartseg_tpu/workloads/train_bce_dice.py; reference train_bce_dice.py):
smp.Unet/resnet34, 512^2, BCE+Dice (w 0.5), AdamW 1e-4 / wd 1e-4,
cosine, early stop patience 7, session-sorted 80/20 split, no ImageNet
normalisation, best-Dice checkpoint, CSV metrics, end-of-run threshold
search over linspace(0.2, 0.8, 13).

Usage:
  python -m cartseg_tpu_torch.workloads.train_bce_dice \
      --images_root DIR --masks_root DIR [--out_dir DIR] [--epochs N] \
      [--device cuda]
  python -m cartseg_tpu_torch.workloads.train_bce_dice \
      --synthetic --img_size 64 --batch_size 2 --epochs 2 --device cpu
Any TrainConfig field is a flag (`--field value`). The default device
is cuda; a machine without a card raises unless `--device cpu` is
given. CARTSEG_PALLAS_BN=force (or 1) runs every train-mode BatchNorm's
sums through the channel-sums CUDA kernel, as it picks `TpuBatchNorm`
in the JAX package.
"""

from cartseg_tpu_torch.train import LossSpec, TrainConfig
from cartseg_tpu_torch.workloads._runner import run

CONFIG = TrainConfig(
    encoder="resnet34",
    img_size=(512, 512),
    imagenet_norm=False,
    batch_size=6,
    epochs=50,
    lr=1e-4,
    weight_decay=1e-4,
    patience=7,
    loss=LossSpec("bce_dice", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_512",
    split="session_sorted",
    metrics_schema="basic",
    threshold_sweep=(0.2, 0.8, 13),
    out_dir="runs/train_bce_dice",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
