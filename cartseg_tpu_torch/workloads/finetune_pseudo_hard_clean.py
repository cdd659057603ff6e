"""Fine-tune a pseudo-trained model on hard+clean with the hard source
oversampled x2 (counterpart of
cartseg_tpu/workloads/finetune_pseudo_hard_clean.py; reference
src/finetune_pseudo_hard_clean.py): weighted sampling that doubles hard
samples (:186-187), 3-group LRs with encoder x 0.3 (:202-206), 512^2
bs6, per-sample BCE+Dice, `basic` CSV and history (:209, 239-244).

Start it from the pseudo checkpoint with `--init_torch_checkpoint
FILE.pth` (the reference .pth, e.g. finetune_pseudo's model.pth). The
JAX package's `--init_checkpoint` (an Orbax directory) is not ported
and raises.

Usage:
  python -m cartseg_tpu_torch.workloads.finetune_pseudo_hard_clean \\
      --sources_json sources.json --init_torch_checkpoint FILE.pth \\
      [--out_dir DIR] [--epochs N] [--device cuda]
sources.json is a JSON list, one object a source, in CONFIG's order:
  [{"name": "hard", "images_root": "data/hard/images",
    "masks_root": "data/hard/masks", "ratio": 1.0, "loss_weight": 1.0,
    "oversample": 2.0},
   {"name": "clean", "images_root": "data/clean/images",
    "masks_root": "data/clean/masks", "ratio": 1.0, "loss_weight": 1.0}]
(keys of train.config.SourceSpec). Masks mirror the images' relative
paths. Any TrainConfig field is a flag (`--field value`); the default
device is cuda.
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
    seed=42,
    loss=LossSpec("bce_dice_per_sample", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_512",
    sources=[
        SourceSpec("hard", "data/hard/images", "data/hard/masks",
                   ratio=1.0, loss_weight=1.0, oversample=2.0),
        SourceSpec("clean", "data/clean/images", "data/clean/masks",
                   ratio=1.0, loss_weight=1.0),
    ],
    val_source="hard",
    val_frac=0.12,
    metrics_schema="basic",
    out_dir="runs/finetune_pseudo_hard_clean",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
