"""SAM editor over the base image pool, no miner (counterpart of
cartseg_tpu/workloads/create_more_specific_data.py; reference
create_more_specific_data.py): skips images already masked in either
output dir (:161-172), saves at 224^2 (:417-423).

  python -m cartseg_tpu_torch.workloads.create_more_specific_data \
      --images_root DIR --out_dir DIR [--also_done DIR] \
      [--checkpoint model.pth] [--sam_checkpoint sam_vit_b.pth] \
      [--device cuda]

The window and seg_friendly need OpenCV (highgui and a display).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cartseg_tpu_torch.tools.annotate import (IMG_EXTS, Proposer,
                                              pending_paths, run_ui)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--also_done", default=None,
                    help="second output dir whose masks also count as done")
    ap.add_argument("--checkpoint", default=None, help="a .pth state dict")
    ap.add_argument("--encoder", default="efficientnet-b0")
    ap.add_argument("--sam_checkpoint", default=None)
    ap.add_argument("--img_size", type=int, default=512)
    ap.add_argument("--save_size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    paths = sorted(p for p in Path(args.images_root).rglob("*")
                   if p.suffix.lower() in IMG_EXTS)
    done_dirs = [Path(args.out_dir)]
    if args.also_done:
        done_dirs.append(Path(args.also_done))
    paths = pending_paths(paths, done_dirs,
                          Path(args.out_dir) / "_skipped")
    proposer = (Proposer(Path(args.checkpoint), args.encoder,
                         img_size=args.img_size, device=args.device)
                if args.checkpoint else None)
    run_ui(paths, Path(args.out_dir), proposer,
           Path(args.sam_checkpoint) if args.sam_checkpoint else None,
           img_size=args.img_size, save_size=args.save_size,
           device=args.device)


if __name__ == "__main__":
    main()
