"""Hard-case mining CLI (counterpart of
cartseg_tpu/workloads/mine_hard_cases.py; reference mine_hard_cases.py),
batched on the device.

  python -m cartseg_tpu_torch.workloads.mine_hard_cases \
      --images_root DIR --out_dir DIR --checkpoints a.pth[,b.pth] \
      [--encoder efficientnet-b0] [--device cuda]

Checkpoints are reference-naming .pth files. The default device is
cuda, and a machine without a card raises rather than running on the
CPU.
"""

from __future__ import annotations

import argparse

from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.infer import MiningConfig, load_member, mine_hard_cases


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--out_dir", default="hard_mining")
    ap.add_argument("--checkpoints", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--encoder", default="efficientnet-b0")
    ap.add_argument("--img_size", type=int, default=512)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--sample_size", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ckpts = args.checkpoints.split(",")
    weights = ([float(w) for w in args.weights.split(",")]
               if args.weights else [1.0] * len(ckpts))
    members = [load_member(p, args.encoder, w, device=device)
               for p, w in zip(ckpts, weights)]
    cfg = MiningConfig(
        images_root=args.images_root, out_dir=args.out_dir,
        img_size=args.img_size, threshold=args.threshold,
        batch_size=args.batch_size, sample_size=args.sample_size,
        seed=args.seed)
    return mine_hard_cases(members, cfg, device=device)


if __name__ == "__main__":
    main()
