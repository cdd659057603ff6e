"""Mask-cleaner CLI (counterpart of cartseg_tpu/workloads/clean_masks.py):
the reference's clean_masks.py / remove_blops.py / clean_complete.py
behind --mode, the cleaning on the device:

  holes_largest  flood-fill holes + keep the largest CC (clean_masks.py)
  largest_only   keep the largest CC only (remove_blops.py)
  complete       cut the letterbox padding (needs --images_root) then
                 open(3) -> largest CC -> close(7) -> fill small holes
                 (clean_complete.py)

  python -m cartseg_tpu_torch.workloads.clean_masks --masks_root DIR \
      [--out_root DIR] [--mode complete --images_root DIR] [--device cuda]

The default device is cuda (a machine without a card raises); the CPU
runs the kernels' plain versions when asked for by name.
"""

from __future__ import annotations

import argparse

from cartseg_tpu_torch.postprocess import CleanConfig, clean_tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--masks_root", required=True)
    ap.add_argument("--images_root", default=None)
    ap.add_argument("--out_root", default=None)
    ap.add_argument("--mode", default="complete",
                    choices=["complete", "holes_largest", "largest_only"])
    ap.add_argument("--side_padding_ratio", type=float, default=0.1)
    ap.add_argument("--open_ks", type=int, default=3)
    ap.add_argument("--close_ks", type=int, default=7)
    ap.add_argument("--hole_frac", type=float, default=0.004)
    ap.add_argument("--skip_existing", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return clean_tree(CleanConfig(
        masks_root=args.masks_root, images_root=args.images_root,
        out_root=args.out_root, mode=args.mode,
        side_padding_ratio=args.side_padding_ratio,
        open_ks=args.open_ks, close_ks=args.close_ks,
        hole_frac=args.hole_frac, skip_existing=args.skip_existing,
        device=args.device))


if __name__ == "__main__":
    main()
