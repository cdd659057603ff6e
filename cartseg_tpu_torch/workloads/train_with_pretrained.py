"""Pretrained-encoder training (counterpart of
cartseg_tpu/workloads/train_with_pretrained.py; reference
src/train_with_pretrained.py): efficientnet-b0 UNet, ImageNet
normalisation (:164-165), the encoder frozen for 8 epochs and then
trained at 0.3 of the learning rate (:335-372), `prf1` CSV (:218-236,
:350-356). The encoder starts from an ImageNet-format file given as
`--pretrained_encoder` (a timm efficientnet_b0 .pth or .npz;
models/pretrained.py), smp's encoder_weights="imagenet".

Usage:
  python -m cartseg_tpu_torch.workloads.train_with_pretrained \\
      --images_root DIR --masks_root DIR --pretrained_encoder FILE \\
      [--out_dir DIR] [--epochs N] [--device cuda]
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
    loss=LossSpec("bce_dice", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_512",
    split="session_sorted",
    freeze_encoder_epochs=8,
    unfreeze_encoder_lr_scale=0.3,
    metrics_schema="prf1",
    out_dir="runs/train_with_pretrained",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
