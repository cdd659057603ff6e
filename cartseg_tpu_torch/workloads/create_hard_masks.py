"""SAM-assisted correction of mined hard cases (counterpart of
cartseg_tpu/workloads/create_hard_masks.py; reference
src/data_preprocessing/create_hard_masks.py): consumes the
hard_candidates.csv ranking, seg_friendly preprocessing, prefetch,
x-to-skip markers, saves at 512^2 (:453-459).

  python -m cartseg_tpu_torch.workloads.create_hard_masks \
      --candidates hard_candidates.csv --out_dir DIR --checkpoint model.pth \
      [--sam_checkpoint sam_vit_b.pth] [--limit 200] [--device cuda]

The window needs OpenCV (highgui and a display); the seg_friendly
preprocessing runs on the device without it. The process keeps float32
math in full float32 (`device.set_fp32_policy`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from cartseg_tpu_torch.device import set_fp32_policy
from cartseg_tpu_torch.tools.annotate import (Proposer,
                                              load_hard_candidates, run_ui)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", required=True,
                    help="hard_candidates.csv from mine_hard_cases")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--checkpoint", default=None, help="a .pth state dict")
    ap.add_argument("--encoder", default="efficientnet-b0")
    ap.add_argument("--sam_checkpoint", default=None)
    ap.add_argument("--img_size", type=int, default=512)
    ap.add_argument("--save_size", type=int, default=512)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # SAM and the proposer in full float32, as the checks hold them
    set_fp32_policy()

    paths = load_hard_candidates(Path(args.candidates), args.limit)
    proposer = (Proposer(Path(args.checkpoint), args.encoder,
                         img_size=args.img_size, device=args.device)
                if args.checkpoint else None)
    run_ui(paths, Path(args.out_dir), proposer,
           Path(args.sam_checkpoint) if args.sam_checkpoint else None,
           img_size=args.img_size, save_size=args.save_size,
           device=args.device)


if __name__ == "__main__":
    main()
