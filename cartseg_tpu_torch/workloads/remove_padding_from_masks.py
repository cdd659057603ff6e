"""Inverse-letterbox CLI (counterpart of
cartseg_tpu/workloads/remove_padding_from_masks.py; reference
remove_padding_from_masks.py).

  python -m cartseg_tpu_torch.workloads.remove_padding_from_masks \
      --masks_root DIR --images_root DIR --out_root DIR [--overlays DIR] \
      [--device cuda]

The original images are read for --device (default cuda: a JPEG is
decoded on the card by nvJPEG, and a machine without a card raises);
masks resize on the host, without OpenCV.
"""

from __future__ import annotations

import argparse

from cartseg_tpu_torch.postprocess import unpad_tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--masks_root", required=True)
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--overlays", default=None)
    ap.add_argument("--side_padding_ratio", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return unpad_tree(args.masks_root, args.images_root, args.out_root,
                      args.side_padding_ratio, args.overlays,
                      device=args.device)


if __name__ == "__main__":
    main()
