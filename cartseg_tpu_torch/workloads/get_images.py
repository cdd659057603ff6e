"""Image <-> mask plumbing CLIs (counterpart of
cartseg_tpu/workloads/get_images.py; reference get_images.py and
sort_pseudo.py), host only.

  python -m cartseg_tpu_torch.workloads.get_images copy-images \
      --masks_root DIR --images_root DIR --out_root DIR
  python -m cartseg_tpu_torch.workloads.get_images copy-masks \
      --src_root DIR --dst_root DIR
"""

from __future__ import annotations

import argparse

from cartseg_tpu_torch.postprocess import copy_masks, copy_matching_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("copy-images")
    p1.add_argument("--masks_root", required=True)
    p1.add_argument("--images_root", required=True)
    p1.add_argument("--out_root", required=True)
    p2 = sub.add_parser("copy-masks")
    p2.add_argument("--src_root", required=True)
    p2.add_argument("--dst_root", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "copy-images":
        return copy_matching_images(args.masks_root, args.images_root,
                                    args.out_root)
    return copy_masks(args.src_root, args.dst_root)


if __name__ == "__main__":
    main()
