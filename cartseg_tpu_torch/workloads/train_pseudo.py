"""Pseudo-label training (counterpart of
cartseg_tpu/workloads/train_pseudo.py; reference src/train_pseudo.py):
several image roots and one merged mask root (`--image_roots a,b`),
pairs gathered across them (data/pairing.py
`gather_pairs_multiroot`) with the store_*/session_* split (:130-153),
seed 1337 (:58-64), efficientnet-b0 UNet, ImageNet normalisation,
`basic` CSV.

Usage:
  python -m cartseg_tpu_torch.workloads.train_pseudo \\
      --image_roots DIR,DIR --masks_root DIR [--out_dir DIR] \\
      [--epochs N] [--device cuda]
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
    loss=LossSpec("bce_dice", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_512",
    split="session_seeded",
    image_roots=[],   # set via --image_roots a,b,c
    metrics_schema="basic",
    out_dir="runs/train_pseudo",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
