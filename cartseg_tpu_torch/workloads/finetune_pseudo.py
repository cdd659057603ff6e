"""224^2 fine-tune on hard+clean+pseudo with per-source loss weights
(counterpart of cartseg_tpu/workloads/finetune_pseudo.py; reference
src/finetune_pseudo.py): efficientnet-b0 UNet, bs8, per-sample
BCE+Dice times the pseudo source's weight 0.5 (:236-239, 289-295), val
on 12 % of the hard source's real labels (:241-244), encoder frozen 2
epochs (:107-125), a 19-point threshold sweep (:210-226).

Usage:
  python -m cartseg_tpu_torch.workloads.finetune_pseudo \\
      --sources_json sources.json [--out_dir DIR] [--epochs N] \\
      [--trace_dir DIR] [--device cuda]
sources.json is a JSON list, one object a source, in CONFIG's order
(hard, clean, pseudo):
  [{"name": "hard", "images_root": "data/hard/images",
    "masks_root": "data/hard/masks", "ratio": 1.0, "loss_weight": 1.0},
   ...,
   {"name": "pseudo", "images_root": "data/pseudo/images",
    "masks_root": "data/pseudo/masks", "ratio": 1.0, "loss_weight": 0.5}]
(keys of train.config.SourceSpec; `oversample` defaults to 1.0). Masks
mirror the images' relative paths. Any TrainConfig field is a flag
(`--field value`); the default device is cuda.
"""

from cartseg_tpu_torch.train import LossSpec, SourceSpec, TrainConfig
from cartseg_tpu_torch.workloads._runner import run

CONFIG = TrainConfig(
    encoder="efficientnet-b0",
    img_size=(224, 224),
    imagenet_norm=True,
    batch_size=8,
    epochs=25,
    lr=1e-4,
    encoder_lr_scale=0.3,
    weight_decay=1e-4,
    patience=5,
    seed=42,
    loss=LossSpec("bce_dice_per_sample", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_224",
    sources=[
        SourceSpec("hard", "data/hard/images", "data/hard/masks",
                   ratio=1.0, loss_weight=1.0),
        SourceSpec("clean", "data/clean/images", "data/clean/masks",
                   ratio=1.0, loss_weight=1.0),
        SourceSpec("pseudo", "data/pseudo/images", "data/pseudo/masks",
                   ratio=1.0, loss_weight=0.5),
    ],
    val_source="hard",
    val_frac=0.12,
    use_curriculum=False,
    freeze_encoder_epochs=2,
    metrics_schema="basic",
    threshold_sweep=(0.05, 0.95, 19),
    out_dir="runs/finetune_pseudo",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
