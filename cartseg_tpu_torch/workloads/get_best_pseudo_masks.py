"""Soft-prob ranker CLI (counterpart of
cartseg_tpu/workloads/get_best_pseudo_masks.py; reference
get_best_pseudo_masks.py), host only.

  python -m cartseg_tpu_torch.workloads.get_best_pseudo_masks \
      --src_root DIR --dst_root DIR [--top_k 1300]
"""

from __future__ import annotations

import argparse

from cartseg_tpu_torch.infer import RankingConfig, rank_pseudo_masks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_root", required=True)
    ap.add_argument("--dst_root", default="best_pseudo")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--top_k", type=int, default=1300)
    args = ap.parse_args(argv)
    return rank_pseudo_masks(RankingConfig(
        src_root=args.src_root, dst_root=args.dst_root,
        threshold=args.threshold, top_k=args.top_k))


if __name__ == "__main__":
    main()
