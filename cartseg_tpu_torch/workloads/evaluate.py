"""Checkpoint evaluation (counterpart of
cartseg_tpu/workloads/evaluate.py): Dice, IoU, precision, recall and F1
over an image/mask tree at a given or swept threshold.

  python -m cartseg_tpu_torch.workloads.evaluate \
      --images_root DIR --masks_root DIR --checkpoint model.pth \
      [--encoder efficientnet-b0] [--img_size 512] [--sweep] [--device cuda]

The JAX workload's semantics (evaluate.py:43-90): the threshold is
--threshold or else the checkpoint's sidecar; each reported metric is
the mean of the per-batch means (a short last batch weighs as much as a
full one); --sweep takes the argmax of the mean per-batch binarized
Dice over np.linspace(0.05, 0.95, 19); --imagenet_norm is always on.
The checkpoint is a reference-naming .pth (a JAX/orbax directory
raises, naming models/convert.py). The default device is cuda, and a
machine without a card raises.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from cartseg_tpu_torch import metrics as M
from cartseg_tpu_torch.data.augment import normalize_batch
from cartseg_tpu_torch.data.dataset import SegmentationDataset
from cartseg_tpu_torch.data.pairing import gather_pairs_mirror
from cartseg_tpu_torch.data.pipeline import Loader
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.infer.engine import load_member
from cartseg_tpu_torch.infer.pseudo_labels import IMAGENET_MEAN, IMAGENET_STD

SWEEP = np.linspace(0.05, 0.95, 19)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--masks_root", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--encoder", default="efficientnet-b0")
    ap.add_argument("--img_size", type=int, default=512)
    ap.add_argument("--imagenet_norm", action="store_true", default=True)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out_json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    member = load_member(args.checkpoint, args.encoder, device=device)
    thr = args.threshold if args.threshold is not None else member.threshold
    mean = IMAGENET_MEAN if args.imagenet_norm else (0, 0, 0)
    std = IMAGENET_STD if args.imagenet_norm else (1, 1, 1)

    pairs = gather_pairs_mirror(Path(args.images_root),
                                Path(args.masks_root))
    if not pairs:
        raise SystemExit("no image/mask pairs found")
    ds = SegmentationDataset(pairs, (args.img_size, args.img_size))
    loader = Loader(ds, args.batch_size, device=device, drop_last=False)
    model = member.model
    dtype = next(model.parameters()).dtype
    ts = torch.from_numpy(SWEEP.astype(np.float32)).to(device)

    @torch.inference_mode()
    def eval_step(images_u8, masks):
        x = normalize_batch(images_u8.to(torch.float32), mean, std)
        logits = model(x.permute(0, 3, 1, 2).to(dtype))
        logits = logits.to(torch.float32).permute(0, 2, 3, 1)   # NHWC
        suite = M.eval_suite(logits, masks, t=thr)
        return suite, M.threshold_sweep_stats(logits, masks, ts)[0]

    suites, sds = [], []
    for imgs, masks in loader(np.arange(len(ds))):
        suite, d = eval_step(imgs, masks)
        suites.append({k: float(v) for k, v in suite.items()})
        sds.append(d.cpu().numpy())

    # keys in sorted order, as the JAX workload's (jit returns the suite
    # as a key-sorted dict)
    out = {k: float(np.mean([s[k] for s in suites]))
           for k in sorted(suites[0])}
    out["threshold"] = thr
    out["n_images"] = len(ds)
    if args.sweep:
        dice_t = np.mean(np.stack(sds), axis=0)
        k = int(np.argmax(dice_t))
        out["best_threshold"] = float(SWEEP[k])
        out["best_threshold_dice"] = float(dice_t[k])
    print(json.dumps(out, indent=2))
    if args.out_json:
        Path(args.out_json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
