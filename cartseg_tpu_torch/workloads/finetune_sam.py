"""Box-prompted SAM ViT-B fine-tune on the cart masks, as MedSAM trains
it (Ma et al., arXiv:2304.12306; its train_one_gpu.py): one box prompt a
frame from its ground-truth mask, each side jittered outward by 0-20 px;
the image encoder and the mask decoder trained, the prompt encoder
frozen; AdamW at lr 1e-4, weight decay 0.01; 1024² frames in SAM's own
normalisation. The port's loss is its BCE+Dice (w 0.5) on the logits
upsampled to 1024², where MedSAM sums Dice and BCE; its batch is 16 a
card, twice MedSAM's 8 (sized for dense attention): the flash global
attention leaves the room (40 GB of an 80 GB H100). A fine-tuned model
sharpens the annotation tool's SAM (`tools/annotate.py`) on the user's
carts.

Usage:
  python -m cartseg_tpu_torch.workloads.finetune_sam \\
      --images_root DIR --masks_root DIR [--init_torch_checkpoint \\
      sam_vit_b_01ec64.pth] [--out_dir DIR] [--epochs N] [--device cuda]
Any TrainConfig field is a flag (`--field value`). An official SAM
checkpoint loads as `init_torch_checkpoint` (its mask-prompt keys are
dropped); without one the model starts from a seeded init. The default
device is cuda; a machine without a card raises unless `--device cpu`
is given.
"""

from cartseg_tpu_torch.train import LossSpec, TrainConfig
from cartseg_tpu_torch.workloads._runner import run

CONFIG = TrainConfig(
    encoder="sam_vit_b",
    img_size=(1024, 1024),
    imagenet_norm=True,
    batch_size=16,
    epochs=50,
    lr=1e-4,
    weight_decay=0.01,
    loss=LossSpec("bce_dice", {"bce_weight": 0.5, "smooth": 1.0}),
    augment="train_512",
    split="session_sorted",
    metrics_schema="basic",
    threshold_sweep=(0.2, 0.8, 13),
    checkpoint_name="medsam",
    out_dir="runs/finetune_sam",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
