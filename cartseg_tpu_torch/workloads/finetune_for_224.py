"""Strict-224 mixed fine-tune (counterpart of
cartseg_tpu/workloads/finetune_for_224.py; reference
src/finetune_for_224.py): hard (0.50) / clean (0.25) / pseudo (0.25)
weighted mixed sampling (:55-58), per-source loss weights with the
pseudo curriculum 0.4 -> 0.6 over 4 epochs (:60-65, 322-324),
per-sample BCE+Dice (:208-221), encoder frozen 2 epochs with encoder LR
3e-5 / head LR 1e-4 (:44-48), val = 12 % of hard (:68), a 19-point
threshold sweep 0.05..0.95 saved as the sidecar (:234-248, 385-388).

Usage:
  python -m cartseg_tpu_torch.workloads.finetune_for_224 \\
      --sources_json sources.json [--out_dir DIR] [--epochs N] \\
      [--device cuda]
sources.json is a JSON list of the three sources, in CONFIG's order
(the curriculum weighs the last one):
  [{"name": "hard", "images_root": "data/hard/images",
    "masks_root": "data/hard/masks", "ratio": 0.5, "loss_weight": 1.0},
   {"name": "clean", "images_root": "data/clean/images",
    "masks_root": "data/clean/masks", "ratio": 0.25, "loss_weight": 1.0},
   {"name": "pseudo", "images_root": "data/pseudo/images",
    "masks_root": "data/pseudo/masks", "ratio": 0.25, "loss_weight": 0.4}]
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
    batch_size=20,
    epochs=20,
    lr=1e-4,                 # head LR (:46)
    encoder_lr_scale=0.3,    # encoder LR 3e-5 (:47)
    weight_decay=1e-4,
    patience=5,
    seed=42,
    loss=LossSpec("bce_dice_per_sample", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_224",
    sources=[
        SourceSpec("hard", "data/hard/images", "data/hard/masks",
                   ratio=0.50, loss_weight=1.0),
        SourceSpec("clean", "data/clean/images", "data/clean/masks",
                   ratio=0.25, loss_weight=1.0),
        SourceSpec("pseudo", "data/pseudo/images", "data/pseudo/masks",
                   ratio=0.25, loss_weight=0.4),
    ],
    val_source="hard",
    val_frac=0.12,
    use_curriculum=True,
    pseudo_w_start=0.4,
    pseudo_w_end=0.6,
    pseudo_ramp_epochs=4,
    freeze_encoder_epochs=2,          # encoder warmup (:44-45, 264-272)
    unfreeze_encoder_lr_scale=1.0,
    metrics_schema="basic",
    threshold_sweep=(0.05, 0.95, 19),
    out_dir="runs/finetune_for_224",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
