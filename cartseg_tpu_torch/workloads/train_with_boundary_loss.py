"""SDF boundary-loss training (counterpart of
cartseg_tpu/workloads/train_with_boundary_loss.py; reference
src/train_with_boundary_loss.py): (1-0.3)*(BCE+Dice) +
0.3*SymmetricBoundaryLoss (:267-282), efficientnet-b0 UNet, ImageNet
normalisation, 512^2 bs6, 8 epochs with the encoder frozen and then an
encoder lr at 0.3 of the others, `prf1` CSV. The SDFs come from the
jump-flood EDT on the device (the CUDA kernel on the card, four
`edt_batch` calls a step) instead of per-sample CPU scipy (:204-217).

Usage:
  python -m cartseg_tpu_torch.workloads.train_with_boundary_loss \
      --images_root DIR --masks_root DIR [--out_dir DIR] [--epochs N] \
      [--device cuda]
  python -m cartseg_tpu_torch.workloads.train_with_boundary_loss \
      --synthetic --img_size 64 --batch_size 2 --epochs 2 --device cpu
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
    loss=LossSpec("boundary", {"bce_weight": 0.5, "boundary_weight": 0.3}),
    augment="train_512",
    freeze_encoder_epochs=8,
    unfreeze_encoder_lr_scale=0.3,
    metrics_schema="prf1",
    out_dir="runs/train_with_boundary_loss",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
