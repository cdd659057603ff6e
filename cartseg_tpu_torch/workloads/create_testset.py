"""Interactive test-set labeling CLI (counterpart of
cartseg_tpu/workloads/create_testset.py; reference src/create_testset.py):
a proposal model and optional SAM point/box prompting on the device, a
prefetch thread, the brush/box editor; saves masks at ORIGINAL
resolution (:391-396).

  python -m cartseg_tpu_torch.workloads.create_testset \
      --images_root DIR --out_dir DIR --checkpoint model.pth \
      [--sam_checkpoint sam_vit_b.pth] [--no_seg_friendly] [--device cuda]

The window needs OpenCV's highgui and a display; the seg_friendly
preprocessing (on unless --no_seg_friendly) runs on the device without
it, and the process keeps float32 math in full float32
(`device.set_fp32_policy`). SAM is optional (brush-only editing
without it). As in the JAX workload, the proposer runs at 512^2 while
the display is at --img_size (1024).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cartseg_tpu_torch.device import set_fp32_policy
from cartseg_tpu_torch.tools.annotate import IMG_EXTS, Proposer, run_ui


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--checkpoint", default=None, help="a .pth state dict")
    ap.add_argument("--encoder", default="efficientnet-b0")
    ap.add_argument("--sam_checkpoint", default=None)
    ap.add_argument("--img_size", type=int, default=1024)
    ap.add_argument("--no_seg_friendly", action="store_true")
    ap.add_argument("--display_scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # SAM and the proposer in full float32, as the checks hold them
    set_fp32_policy()

    paths = sorted(p for p in Path(args.images_root).rglob("*")
                   if p.suffix.lower() in IMG_EXTS)
    proposer = (Proposer(Path(args.checkpoint), args.encoder,
                         device=args.device)
                if args.checkpoint else None)
    run_ui(paths, Path(args.out_dir), proposer,
           Path(args.sam_checkpoint) if args.sam_checkpoint else None,
           img_size=args.img_size, save_size=None, save_original_res=True,
           make_easy=not args.no_seg_friendly,
           display_scale=args.display_scale, device=args.device)


if __name__ == "__main__":
    main()
