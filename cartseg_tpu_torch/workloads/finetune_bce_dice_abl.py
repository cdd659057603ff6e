"""Fine-tune with BCE+Dice+ABL on hard+clean (counterpart of
cartseg_tpu/workloads/finetune_bce_dice_abl.py; reference
src/training/finetune_BCEDice_ABL.py): efficientnet-b0 UNet, 512^2 bs6,
30 epochs, encoder LR x 0.3, abl_weight 0.1, val = 12 % of hard, `abl`
CSV. The ABL loss runs the EDT and LSR kernels on the card.

Usage:
  python -m cartseg_tpu_torch.workloads.finetune_bce_dice_abl \\
      --sources_json sources.json [--init_torch_checkpoint FILE.pth] \\
      [--out_dir DIR] [--epochs N] [--device cuda]
sources.json is a JSON list, one object a source, in CONFIG's order:
  [{"name": "hard", "images_root": "data/hard/images",
    "masks_root": "data/hard/masks", "ratio": 1.0, "loss_weight": 1.0},
   {"name": "clean", ...}]
(keys of train.config.SourceSpec; `oversample` defaults to 1.0). Masks
mirror the images' relative paths. Any TrainConfig field is a flag
(`--field value`); the default device is cuda.
"""

from cartseg_tpu_torch.train import LossSpec, SourceSpec, TrainConfig
from cartseg_tpu_torch.workloads._runner import run

CONFIG = TrainConfig(
    encoder="efficientnet-b0",
    img_size=(512, 512),
    imagenet_norm=True,
    batch_size=6,
    epochs=30,
    lr=1e-4,
    encoder_lr_scale=0.3,
    weight_decay=1e-4,
    patience=6,
    seed=1337,
    loss=LossSpec("bce_dice_abl", {"bce_weight": 0.5, "abl_weight": 0.1}),
    augment="train_512",
    sources=[
        SourceSpec("hard", "data/hard/images", "data/hard/masks",
                   ratio=1.0, loss_weight=1.0),
        SourceSpec("clean", "data/clean/images", "data/clean/masks",
                   ratio=1.0, loss_weight=1.0),
    ],
    val_source="hard",
    val_frac=0.12,
    metrics_schema="abl",
    out_dir="runs/finetune_bce_dice_abl",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
