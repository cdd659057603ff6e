"""ABL training on the unlettered tree (counterpart of
cartseg_tpu/workloads/train_bce_dice_abl_unlettered.py; reference
src/training/abl_training/train_BCEDice_ABL.py): the plain square
letterbox without side padding (:83-96), otherwise
train_bce_dice_abl's CONFIG, so the EDT and both LSR kernels run on the
card.

Usage:
  python -m cartseg_tpu_torch.workloads.train_bce_dice_abl_unlettered \\
      --images_root DIR --masks_root DIR [--out_dir DIR] [--epochs N] \\
      [--device cuda]
Any TrainConfig field is a flag (`--field value`). The default device
is cuda; a machine without a card raises unless `--device cpu` is
given.
"""

from cartseg_tpu_torch.workloads._runner import run
from cartseg_tpu_torch.workloads.train_bce_dice_abl import CONFIG as _BASE

CONFIG = _BASE.with_overrides(
    side_padding_ratio=0.0,
    out_dir="runs/train_bce_dice_abl_unlettered",
)


def main(argv=None, log=print):
    return run(CONFIG, argv, log=log)


if __name__ == "__main__":
    main()
